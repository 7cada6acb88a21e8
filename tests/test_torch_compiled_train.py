"""The captured BiasNet training step (``models.bias_net.train_step``, the
JAX package's jitted ``train_step``) on the CPU, where its stage runs as a
plain call on the static buffers of ``graphs.TrainGraphs``.

1. Three steps of ``train_step`` equal ``train_step_eager`` bit for bit
   (parameters, Adam slots, losses), from a ``create_train_state`` state
   and from a plain ``torch.optim.Adam`` built as tests/test_torch_train.py
   builds it; against optax on the JAX package's own batches at
   tests/test_torch_train.py's tolerances (losses within 1e-2 relative; at
   least 95% of parameter entries within 1e-4 and every entry within 2 *
   lr * steps: Adam's first steps move a parameter by about lr whatever
   its gradient's size, so a near-zero gradient whose sign two
   frameworks round differently moves it by a whole lr step).
2. The warm-up before a capture runs on a scratch twin: the caller's
   parameters and slots stay as they were.  The set lives with its
   optimizer: one a batch shape, serving any learning rate (the constants
   are a buffer), replaced by a ``load_state_dict`` and dropped with the
   optimizer.
3. A checkpoint round trip after compiled steps: the npz parameters (the
   JAX package's format) and the optimizer's state dict, the resumed run
   equal to the uninterrupted one.
4. ``train_bias_net`` and ``train_bias_net_mixed`` step through it.
"""

import copy
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icet_tpu.models import bias_net as jb
from icet_tpu_torch import graphs
from icet_tpu_torch.convert import bias_net_params_from_numpy, bias_net_params_to_numpy
from icet_tpu_torch.models import bias_net as tb
from icet_tpu_torch.models import train_data as ttd
from icet_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

S = 16
LR = 1e-3
STEPS = 3

_jax_batch = jax.jit(jb.make_patch_batch, static_argnums=(1, 2))


def _batches(n=STEPS, batch=32, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return [tb.make_patch_batch(gen, batch, S, device="cpu") for _ in range(n)]


def _state(seed=0):
    return tb.create_train_state(torch.Generator().manual_seed(seed), LR, S, device="cpu")


def _slots(state):
    return [t for slot in tb._adam_slots(state.opt)[1] for t in slot]


def _same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("opt", ["create_train_state", "plain_adam"])
def test_train_step_equals_eager(opt):
    states = [_state(), _state()]
    if opt == "plain_adam":
        states = [tb.TrainState(s.model, torch.optim.Adam(s.model.parameters(), lr=LR,
                                                          betas=(0.9, 0.999), eps=1e-8), 0)
                  for s in states]
    got, want = states
    copies = graphs.host_ops["copies"]
    for x, y in _batches():
        got, l_got = tb.train_step(got, x, y)
        want, l_want = tb.train_step_eager(want, x, y)
        assert torch.equal(l_got, l_want)
    # Batch in and loss out each step, the Adam constants once.
    assert graphs.host_ops["copies"] - copies == 3 * STEPS + 1
    assert got.step == want.step == STEPS
    _same(got.model.parameters(), want.model.parameters())
    _same(_slots(got), _slots(want))
    assert float(_slots(got)[0]) == STEPS


def test_train_step_matches_optax():
    model, tx = jb.BiasNet(), optax.adam(LR)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2 * S, 4)))
    jstate = jb.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    net = tb.TrainableBiasNet()
    sd = bias_net_params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    net.load_state_dict({k: v for k, v in sd.items() if not k.endswith("_bf16")})
    tstate = tb.TrainState(net, torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999),
                                                 eps=1e-8), 0)
    key = jax.random.PRNGKey(5)
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        xi, yi = _jax_batch(sub, 32, S)
        jstate, jloss = jb.train_step(model, tx, jstate, xi, yi)
        tstate, tloss = tb.train_step(tstate, torch.from_numpy(np.array(xi)),
                                      torch.from_numpy(np.array(yi)))
        assert abs(float(tloss) - float(jloss)) <= 1e-2 * float(jloss)
    got = bias_net_params_to_numpy(net)["params"]
    want = jax.tree_util.tree_map(np.asarray, jstate.params)["params"]
    diffs = np.concatenate([np.abs(got[m][k] - want[m][k]).ravel()
                            for m in want for k in want[m]])
    assert np.mean(diffs <= 1e-4) >= 0.95, np.mean(diffs <= 1e-4)
    assert diffs.max() <= 2 * LR * STEPS, diffs.max()


def test_warmup_leaves_the_callers_state():
    st = _state()
    (x, y), = _batches(1)
    params, slots, hyper = tb._adam_slots(st.opt)
    tg = graphs.train_graphs(st.opt, st.model, params, slots, x.shape, y.shape)
    tg.load(x, y, hyper)
    before = [p.detach().clone() for p in params], [t.clone() for s in slots for t in s]
    scratch = tg.scratch()
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(scratch.params, params))
    assert torch.equal(scratch.hyper, tg.buffers.hyper)
    scratch.x.copy_(x)
    scratch.y.copy_(y)
    tb._train_stage(scratch)
    _same(params, before[0])
    _same([t for s in slots for t in s], before[1])
    assert float(scratch.slots[0][0]) == 1.0 and float(scratch.loss) > 0
    assert not torch.equal(scratch.params[0], params[0])
    # The optimizer holds the set: the same state finds it.
    assert graphs.train_graphs(st.opt, st.model, params, slots, x.shape, y.shape) is tg


def test_one_set_serves_a_learning_rate_schedule():
    got, want = _state(), _state()
    sets = []
    for lr, (x, y) in zip((LR, 5e-4, 2e-4), _batches()):
        for st in (got, want):
            st.opt.param_groups[0]["lr"] = lr
        got, l_got = tb.train_step(got, x, y)
        want, l_want = tb.train_step_eager(want, x, y)
        assert torch.equal(l_got, l_want)
        sets.append(graphs._TRAIN[got.opt][(torch.device("cpu"), x.shape, y.shape)])
        assert float(sets[-1].buffers.hyper[0]) == np.float32(-lr)
    assert len(graphs._TRAIN[got.opt]) == 1 and all(tg is sets[0] for tg in sets)
    _same(got.model.parameters(), want.model.parameters())
    _same(_slots(got), _slots(want))


def test_train_sets_live_with_the_optimizer():
    st = _state()
    (x, y), = _batches(1)
    st, _ = tb.train_step(st, x, y)
    tg = weakref.ref(next(iter(graphs._TRAIN[st.opt].values())))
    # A new optimizer state (as loaded from a file) replaces the set; it is
    # not kept beside it.
    st.opt.load_state_dict(copy.deepcopy(st.opt.state_dict()))
    st, _ = tb.train_step(st, x, y)
    assert len(graphs._TRAIN[st.opt]) == 1
    gc.collect()
    assert tg() is None
    tg = weakref.ref(next(iter(graphs._TRAIN[st.opt].values())))
    n = len(graphs._TRAIN)
    del st
    gc.collect()
    assert tg() is None and len(graphs._TRAIN) == n - 1


def test_checkpoint_round_trip_after_compiled_steps(tmp_path):
    batches = _batches(4)
    whole = _state()
    for x, y in batches:
        whole, _ = tb.train_step(whole, x, y)
    st = _state()
    for x, y in batches[:2]:
        st, _ = tb.train_step(st, x, y)
    path = str(tmp_path / "net")
    tckpt.save_checkpoint(path, bias_net_params_to_numpy(st.model))
    torch.save(st.opt.state_dict(), tmp_path / "opt.pt")
    net = tb.TrainableBiasNet()
    tree = tckpt.load_checkpoint(path + ".npz")
    net.load_state_dict({k: v for k, v in bias_net_params_from_numpy(tree).items()
                         if not k.endswith("_bf16")})
    _same(net.parameters(), st.model.parameters())
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    opt.load_state_dict(torch.load(tmp_path / "opt.pt"))
    resumed = tb.TrainState(net, opt, st.step)
    for x, y in batches[2:]:
        resumed, _ = tb.train_step(resumed, x, y)
    _same(resumed.model.parameters(), whole.model.parameters())
    _same(_slots(resumed), _slots(whole))


def test_train_bias_net_runs_on_it(monkeypatch):
    calls = []
    real = graphs.train_graphs
    monkeypatch.setattr(graphs, "train_graphs", lambda *a: calls.append(1) or real(*a))
    st, losses = tb.train_bias_net(torch.Generator().manual_seed(1), steps=3, batch=16,
                                   sample_pts=S, device="cpu")
    assert len(calls) == 3 and st.step == 3 and all(np.isfinite(losses))


def test_train_bias_net_mixed_runs_on_it(monkeypatch):
    pool = (np.random.default_rng(0).normal(size=(40, S, 3)).astype(np.float32),) * 2
    monkeypatch.setattr(ttd, "make_raycast_voxel_pairs", lambda **kw: pool)
    calls = []
    real = graphs.train_graphs
    monkeypatch.setattr(graphs, "train_graphs", lambda *a: calls.append(1) or real(*a))
    st, losses, _ = ttd.train_bias_net_mixed(steps=4, batch=8, sample_pts=S, device="cpu")
    assert len(calls) == 4 and st.step == 4 and all(np.isfinite(losses))
