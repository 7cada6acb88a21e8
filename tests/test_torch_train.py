"""BiasNet training in the port (``models/bias_net.py``) against flax and
optax in the JAX package (``icet_tpu/models/bias_net.py:211-314``).

The trainable module computes flax's forward (bf16 Dense and LayerNorm,
float32 head) on the JAX package's own initial parameters, carried across
by the converter.  Tolerances: pooled codes within one bf16 ulp (2^-7
relative) on at least 99.5% of entries and outputs within 2e-2, the gates
the encoder kernel is held to; the loss within 1e-4 relative.  Three Adam
steps on JAX's own batches: losses within 1e-2 relative; at least 95% of
parameter entries within 1e-4 of optax's and every entry within 2 * lr *
steps, since Adam turns the sign of a near-zero bf16 gradient, which the
two frameworks may round differently, into a whole lr step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icet_tpu.models import bias_net as jb
from icet_tpu.utils import checkpoint as jckpt
from icet_tpu_torch.convert import bias_net_params_from_numpy, bias_net_params_to_numpy
from icet_tpu_torch.models import bias_net as tb
from icet_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

S = 16
LR = 1e-3
CODE_RTOL, CODE_SHARE, OUT_ATOL = 2.0**-7, 0.995, 2e-2


def _trainable(params) -> tb.TrainableBiasNet:
    """A trainable port module holding a flax parameter tree."""
    net = tb.TrainableBiasNet()
    state = bias_net_params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    net.load_state_dict({k: v for k, v in state.items() if not k.endswith("_bf16")})
    return net


#: the JAX package's batch maker, compiled once (eager JAX compiles op by op)
_jax_batch = jax.jit(jb.make_patch_batch, static_argnums=(1, 2))


@pytest.fixture(scope="module")
def jax_init():
    """``create_train_state``'s model, optimiser and state, with the
    parameters initialised under ``jit`` (the same draws), and a batch."""
    model, tx = jb.BiasNet(), optax.adam(LR)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2 * S, 4)))
    state = jb.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    x, y = _jax_batch(jax.random.PRNGKey(1), 8, S)
    return model, tx, state, np.array(x), np.array(y)


def _flax_codes(model, params, x):
    """Pooled codes of flax's forward: the last LayerNorm's bf16 output
    through ReLU, maxed over the points."""
    _, inter = jax.jit(lambda p, v: model.apply(p, v, capture_intermediates=True))(
        params, jnp.asarray(x))
    ln = inter["intermediates"]["LayerNorm_2"]["__call__"][0]
    return np.asarray(jnp.max(jax.nn.relu(ln), axis=-2).astype(jnp.float32))


def test_forward_matches_flax(jax_init):
    model, _, state, x, _ = jax_init
    net = _trainable(state.params)
    xt = torch.from_numpy(x)
    codes = net.encode(xt).detach().numpy()
    want_codes = _flax_codes(model, state.params, x)
    close = np.mean(np.abs(codes - want_codes) <= CODE_RTOL * np.abs(want_codes))
    assert close >= CODE_SHARE, close
    out = net(xt).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(jax.jit(model.apply)(state.params, x)), rtol=0,
                               atol=OUT_ATOL)


def test_mae_loss_matches(jax_init):
    model, _, state, x, y = jax_init
    want = float(jax.jit(lambda p, a, b: jb.mae_loss(model, p, a, b))(
        state.params, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = float(tb.mae_loss(_trainable(state.params), torch.from_numpy(x),
                                torch.from_numpy(y)))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_train_steps_match_optax(jax_init):
    model, tx, jstate, _, _ = jax_init
    net = _trainable(jstate.params)
    tstate = tb.TrainState(net, torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999),
                                                 eps=1e-8), 0)
    key = jax.random.PRNGKey(5)
    steps = 3
    for _ in range(steps):
        key, sub = jax.random.split(key)
        xi, yi = _jax_batch(sub, 32, S)
        jstate, jloss = jb.train_step(model, tx, jstate, xi, yi)
        tstate, tloss = tb.train_step(tstate, torch.from_numpy(np.array(xi)),
                                      torch.from_numpy(np.array(yi)))
        assert abs(float(tloss) - float(jloss)) <= 1e-2 * float(jloss), (tloss, jloss)
    assert tstate.step == steps
    got = bias_net_params_to_numpy(net)["params"]
    want = jax.tree_util.tree_map(np.asarray, jstate.params)["params"]
    assert sorted(got) == sorted(want)
    diffs = np.concatenate([np.abs(got[m][k] - want[m][k]).ravel()
                            for m in want for k in want[m]])
    assert np.mean(diffs <= 1e-4) >= 0.95, np.mean(diffs <= 1e-4)
    assert diffs.max() <= 2 * LR * steps, diffs.max()


def test_init_follows_flax():
    """lecun_normal kernels (a unit normal truncated at +-2, scaled to
    variance 1 / fan_in), zero biases, LayerNorm scale 1."""
    st = tb.create_train_state(torch.Generator().manual_seed(0), LR, S, device="cpu")
    params = dict(st.model.named_parameters())
    for name, p in params.items():
        if name.endswith("_w"):
            fan_in = p.shape[0]
            assert float(p.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
            if p.numel() >= 4096:
                assert abs(float(p.std()) * np.sqrt(fan_in) - 1.0) < 0.05
        elif name.endswith("_scale"):
            assert bool((p == 1).all())
        else:
            assert bool((p == 0).all())
    again = tb.create_train_state(torch.Generator().manual_seed(0), LR, S, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(st.model.parameters(),
                                                   again.model.parameters()))


def test_make_patch_batch():
    gen = torch.Generator().manual_seed(3)
    x, y = tb.make_patch_batch(gen, batch=64, sample_pts=S, device="cpu")
    assert x.shape == (64, 2 * S, 4) and y.shape == (64, 3)
    assert x.dtype == torch.float32 and y.dtype == torch.float32
    assert float(y.abs().max()) <= 0.3
    assert float(y.std()) > 0.1  # spread over the +-0.3 m range
    np.testing.assert_array_equal(x[:, :S, 3].numpy(), -1.0)
    np.testing.assert_array_equal(x[:, S:, 3].numpy(), 1.0)
    # Centred on the joint mean.
    np.testing.assert_allclose(x[..., :3].mean(dim=1).numpy(), 0.0, atol=1e-5)
    # Sample 2 minus sample 1 carries the target: mean offsets track it.
    shift = (x[:, S:, :3].mean(dim=1) - x[:, :S, :3].mean(dim=1)).numpy()
    assert np.corrcoef(shift[:, 0], y[:, 0].numpy())[0, 1] > 0.5
    # Points lie within 2 m extents of their patch (plus the 0.3 m shift).
    assert float(x[..., :3].abs().max()) < 3.0


def test_train_bias_net_runs():
    st, losses = tb.train_bias_net(torch.Generator().manual_seed(1), steps=3, batch=16,
                                   sample_pts=S, device="cpu")
    assert st.step == 3 and len(losses) == 3 and all(np.isfinite(losses))


def test_serving_matches_trainable():
    st = tb.create_train_state(torch.Generator().manual_seed(2), LR, S, device="cpu")
    x, _ = tb.make_patch_batch(torch.Generator().manual_seed(4), 8, S, device="cpu")
    serving = tb.to_serving(st)
    assert isinstance(serving, tb.BiasNet)
    want = st.model(x).detach()
    got = serving(x)
    assert float((got - want).abs().max()) <= OUT_ATOL
    for i in range(3):
        np.testing.assert_array_equal(getattr(serving, f"enc{i}_b").numpy(),
                                      getattr(st.model, f"enc{i}_b").detach().numpy())


def test_checkpoint_port_to_jax(tmp_path, jax_init):
    """Port -> npz -> the JAX package's load_checkpoint and flax apply,
    equal to the port's forward; the manifest as the JAX package writes."""
    model, _, state, x, _ = jax_init
    net = _trainable(state.params)
    path = str(tmp_path / "port_net")
    tckpt.save_checkpoint(path, bias_net_params_to_numpy(net))
    jpath = str(tmp_path / "jax_net")
    jckpt.save_checkpoint(jpath, jax.tree_util.tree_map(np.asarray, state.params))
    with open(path + ".npz.manifest.json") as f, open(jpath + ".npz.manifest.json") as g:
        assert json.load(f) == json.load(g)
    loaded = jax.tree_util.tree_map(jnp.asarray, jckpt.load_checkpoint(path))
    apply = jax.jit(model.apply)
    out = np.asarray(apply(loaded, jnp.asarray(x)))
    np.testing.assert_allclose(out, net(torch.from_numpy(x)).detach().numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(out, np.asarray(apply(state.params, jnp.asarray(x))))


def test_checkpoint_jax_to_port(tmp_path, jax_init):
    """A JAX npz -> the port's load_pretrained and load_checkpoint."""
    model, _, state, x, _ = jax_init
    path = str(tmp_path / "jax_net.npz")
    jckpt.save_checkpoint(path, jax.tree_util.tree_map(np.asarray, state.params))
    tree = tckpt.load_checkpoint(path)
    want = jax.tree_util.tree_map(np.asarray, state.params)
    got_flat, want_flat = tckpt._flatten(tree), tckpt._flatten(want)
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k])
    serving = tb.load_pretrained(path=path)
    out = serving(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax.jit(model.apply)(state.params, x)), rtol=0,
                               atol=OUT_ATOL)
