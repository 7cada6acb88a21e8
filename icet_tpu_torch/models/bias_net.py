"""The perspective-shift bias network (``icet_tpu/models/bias_net.py``):
inference and training.

A PointNet-style per-voxel regressor: each voxel's input is ``(2S, 4)``, the
S points sampled from each of two scans, centred on their joint mean, with
a scan-id channel (-1 / +1).  A shared per-point encoder (three
Dense+LayerNorm+ReLU stages of 64, 128 and 256 features, in bf16)
max-pools to a 256-wide code; a float32 head (128, 64 -> 3) predicts the
voxel's inter-scan translation.

Inference (:class:`BiasNet`) follows the JAX package's fused semantics
(``apply_bias_net`` with ``fused=True``), stage 1 included: the encoder and
pool are the CUDA kernel of ``ops/bias_encoder.py`` on the card and its
plain version on the CPU.

Training (:class:`TrainableBiasNet`, :func:`train_step`,
:func:`train_bias_net`) follows the JAX package's flax forward
(``BiasNet.__call__``), as the JAX package trains through ``model.apply``
and never through its Pallas kernel: float32 parameters, bf16 Dense and
LayerNorm, autograd for the backward, ``torch.optim.Adam`` with optax's
constants.  :func:`to_serving` turns a trained net into the inference
module.  Random draws come from an explicit ``torch.Generator``; they are
not the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import torch
from torch import nn

from icet_tpu_torch.convert import bias_net_params_from_numpy, bias_net_params_to_numpy
from icet_tpu_torch.device import resolve_device
from icet_tpu_torch.ops.bias_encoder import (  # noqa: F401  (re-exported)
    FEATURES,
    IN_DIM,
    LN_EPS,
    bias_encoder_pool,
    dense_ln_relu_reference,
    encoder_pool_reference,
)
from icet_tpu_torch.utils.checkpoint import load_checkpoint

HEAD = (128, 64)
OUT_DIM = 3
#: the JAX package's bundled weights (read as data with numpy)
WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "icet_tpu" / "models" / "weights"


class BiasNet(nn.Module):
    """Per-voxel translation regressor over two point samples:
    ``(B, 2S, 4) -> (B, 3)``.  Weights are buffers in the JAX package's
    ``(in, out)`` layout; see :func:`convert.bias_net_params_from_numpy`.
    The encoder reads the bf16 copies of its kernels and biases; the
    float32 originals are kept for :func:`convert.bias_net_params_to_numpy`."""

    def __init__(self, features: tuple = FEATURES, head: tuple = HEAD):
        super().__init__()
        self.features = tuple(features)
        self.head = tuple(head)
        dims = (IN_DIM,) + self.features
        for i, (c, f) in enumerate(zip(dims[:-1], dims[1:])):
            self.register_buffer(f"enc{i}_w", torch.zeros(c, f))
            self.register_buffer(f"enc{i}_w_bf16", torch.zeros(c, f, dtype=torch.bfloat16))
            self.register_buffer(f"enc{i}_b", torch.zeros(f))
            self.register_buffer(f"enc{i}_b_bf16", torch.zeros(f, dtype=torch.bfloat16))
            self.register_buffer(f"ln{i}_scale", torch.ones(f))
            self.register_buffer(f"ln{i}_bias", torch.zeros(f))
        hdims = (self.features[-1],) + self.head + (OUT_DIM,)
        for j, (c, f) in enumerate(zip(hdims[:-1], hdims[1:])):
            self.register_buffer(f"head{j}_w", torch.zeros(c, f))
            self.register_buffer(f"head{j}_b", torch.zeros(f))

    def encoder_weights(self) -> list:
        """``[w_bf16, b_bf16, ln_scale, ln_bias]`` per encoder stage."""
        out = []
        for i in range(len(self.features)):
            out += [getattr(self, f"enc{i}_w_bf16"), getattr(self, f"enc{i}_b_bf16"),
                    getattr(self, f"ln{i}_scale"), getattr(self, f"ln{i}_bias")]
        return out

    def head_weights(self) -> list:
        return [(getattr(self, f"head{j}_w"), getattr(self, f"head{j}_b"))
                for j in range(len(self.head) + 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_bias_net(self, x)


def pack_voxel_samples(sample1: torch.Tensor, sample2: torch.Tensor) -> torch.Tensor:
    """The network input from two ``(B, S, 3)`` samples: both centred on
    their joint mean, tagged -1 (scan 1) and +1 (scan 2)."""
    both = torch.cat([sample1, sample2], dim=-2)
    both = both - both.mean(dim=-2, keepdim=True)
    tag = torch.cat([
        -torch.ones(sample1.shape[:-1] + (1,), dtype=sample1.dtype, device=sample1.device),
        torch.ones(sample2.shape[:-1] + (1,), dtype=sample2.dtype, device=sample2.device),
    ], dim=-2)
    return torch.cat([both, tag], dim=-1)


def apply_bias_net(net: BiasNet, x: torch.Tensor, tile: int = 16) -> torch.Tensor:
    """``(B, 2S, 4) -> (B, 3)``: the encoder and pool (the CUDA kernel on
    CUDA tensors, ``tile`` voxels a block; the plain version on CPU ones),
    then the float32 head, as the JAX package computes it outside its
    kernel."""
    g = bias_encoder_pool(x.contiguous(), net.encoder_weights(), tile)
    heads = net.head_weights()
    for w, b in heads[:-1]:
        g = torch.relu(g @ w + b)
    w, b = heads[-1]
    return g @ w + b


def load_pretrained(sample_pts: int = 100, path=None) -> BiasNet:
    """The bundled pretrained BiasNet (``bias_net_s{sample_pts}.npz`` of the
    JAX package, or ``path``), on the CPU."""
    if path is None:
        path = WEIGHTS_DIR / f"bias_net_s{sample_pts}.npz"
    net = BiasNet()
    net.load_state_dict(bias_net_params_from_numpy(load_checkpoint(path)))
    return net.eval()


# ---------------------------------------------------------------------------
# Training (icet_tpu/models/bias_net.py:211-314)
# ---------------------------------------------------------------------------


class TrainableBiasNet(nn.Module):
    """The flax ``BiasNet`` as a trainable module: ``(B, 2S, 4) -> (B, 3)``.

    Float32 parameters named as :class:`BiasNet`'s buffers (kernels laid out
    ``(in, out)``).  Each encoder stage computes as flax's ``nn.Dense`` and
    ``nn.LayerNorm`` with ``dtype=bf16``: input, kernel and bias cast to
    bf16, the product accumulated in float32 and rounded to bf16, the bias
    added in bf16; LayerNorm statistics in float32 with the fast variance
    ``max(E[a^2] - mu^2, 0)`` and eps 1e-6, then ``(a - mu) * (rsqrt(var +
    eps) * scale) + bias`` rounded to bf16 (flax's order, which is not
    ``torch.nn.LayerNorm``'s); ReLU in bf16; the max over the points in
    bf16 (ties share the gradient, as in JAX); then the float32 head."""

    def __init__(self, features: tuple = FEATURES, head: tuple = HEAD):
        super().__init__()
        self.features = tuple(features)
        self.head = tuple(head)
        dims = (IN_DIM,) + self.features
        for i, (c, f) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"enc{i}_w", nn.Parameter(torch.zeros(c, f)))
            setattr(self, f"enc{i}_b", nn.Parameter(torch.zeros(f)))
            setattr(self, f"ln{i}_scale", nn.Parameter(torch.ones(f)))
            setattr(self, f"ln{i}_bias", nn.Parameter(torch.zeros(f)))
        hdims = (self.features[-1],) + self.head + (OUT_DIM,)
        for j, (c, f) in enumerate(zip(hdims[:-1], hdims[1:])):
            setattr(self, f"head{j}_w", nn.Parameter(torch.zeros(c, f)))
            setattr(self, f"head{j}_b", nn.Parameter(torch.zeros(f)))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder and pool: ``(B, 2S, 4) -> (B, 256)`` float32 codes."""
        bf16 = torch.bfloat16
        h = x.to(bf16)
        for i in range(len(self.features)):
            w, b = getattr(self, f"enc{i}_w"), getattr(self, f"enc{i}_b")
            # Products of bf16 values are exact in float32; the sum is
            # float32, rounded to bf16 once.
            a = (h.float() @ w.to(bf16).float()).to(bf16) + b.to(bf16)
            af = a.float()
            mu = af.mean(dim=-1, keepdim=True)
            var = torch.clamp((af * af).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
            mul = torch.rsqrt(var + LN_EPS) * getattr(self, f"ln{i}_scale")
            y = (af - mu) * mul + getattr(self, f"ln{i}_bias")
            h = torch.relu(y.to(bf16))
        return h.amax(dim=-2).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.encode(x)
        for j in range(len(self.head)):
            g = torch.relu(g @ getattr(self, f"head{j}_w") + getattr(self, f"head{j}_b"))
        j = len(self.head)
        return g @ getattr(self, f"head{j}_w") + getattr(self, f"head{j}_b")


def _init_params(net: TrainableBiasNet, generator: torch.Generator) -> None:
    """Flax's initialisation, in place: Dense kernels ``lecun_normal``
    (a normal truncated at two deviations, scaled to variance
    ``1 / fan_in``), zero biases, LayerNorm scale 1 and bias 0.  Draws come
    from ``generator`` on its own device."""
    with torch.no_grad():
        for name, prm in net.named_parameters():
            if name.endswith("_w"):
                # jax.nn.initializers.variance_scaling(1, "fan_in",
                # "truncated_normal"): the stddev of a unit normal
                # truncated to [-2, 2] is 0.87962566103423978.
                std = math.sqrt(1.0 / prm.shape[0]) / 0.87962566103423978
                draw = torch.empty(prm.shape, device=generator.device)
                nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
                prm.copy_(draw * std)
            elif name.endswith("_scale"):
                prm.fill_(1.0)
            else:
                prm.zero_()


@dataclasses.dataclass
class TrainState:
    """A training run's state.  ``model`` and ``opt`` are updated in place
    by :func:`train_step` (the JAX package returns new pytrees instead);
    ``step`` counts the steps taken."""

    model: TrainableBiasNet
    opt: torch.optim.Optimizer
    step: int = 0


def create_train_state(
    generator: torch.Generator,
    lr: float = 1e-3,
    sample_pts: int = 100,
    device: str | torch.device | None = None,
) -> TrainState:
    """A freshly initialised :class:`TrainableBiasNet` on ``device`` (CUDA
    unless told otherwise) with ``optax.adam(lr)``'s optimiser.
    ``sample_pts`` is the S of the ``(B, 2S, 4)`` inputs; the parameters do
    not depend on it."""
    dev = resolve_device(device)
    del sample_pts
    net = TrainableBiasNet()
    _init_params(net, generator)
    net = net.to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(net, opt, 0)


def mae_loss(model: nn.Module, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean absolute error, the training loss."""
    return torch.mean(torch.abs(model(inputs) - targets))


def train_step(state: TrainState, inputs: torch.Tensor, targets: torch.Tensor):
    """One Adam step on the batch; returns ``(state, loss)``, the loss a 0-d
    tensor on the model's device (no read back to the host)."""
    state.opt.zero_grad(set_to_none=True)
    loss = mae_loss(state.model, inputs, targets)
    loss.backward()
    state.opt.step()
    return dataclasses.replace(state, step=state.step + 1), loss.detach()


def make_patch_batch(
    generator: torch.Generator,
    batch: int = 256,
    sample_pts: int = 100,
    device: str | torch.device | None = None,
):
    """Random oriented planar patches sampled twice: ``(inputs (B, 2S, 4),
    targets (B, 3))``, the JAX package's distribution.  Sample 2 sees a
    window of the patch shifted by up to +-0.4 of its extent and is
    translated by the target, uniform in +-0.3 m.  Draws come from
    ``generator`` on its own device; the batch goes to ``device`` (the
    generator's by default)."""
    gdev = generator.device
    dev = gdev if device is None else torch.device(device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=gdev) * (hi - lo) + lo

    normal = torch.randn((batch, 3), generator=generator, device=gdev)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=gdev) + 1e-3
    a = torch.linalg.cross(normal, up.expand_as(normal))
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = torch.linalg.cross(normal, a)
    ext = uniform((batch, 2), 0.2, 2.0)

    def draw(shift_frac):
        u = uniform((batch, sample_pts, 2), -1.0, 1.0)
        # Perspective shift: each scan sees a slightly different window.
        u = u * (1.0 - torch.abs(shift_frac)) + shift_frac
        pts = (u[..., :1] * ext[:, None, :1] * a[:, None, :]
               + u[..., 1:] * ext[:, None, 1:] * b[:, None, :])
        noise = 0.02 * torch.randn(pts.shape, generator=generator, device=gdev)
        return pts + noise * normal[:, None, :]

    window = uniform((batch, 1, 1), -0.4, 0.4)
    s1 = draw(torch.zeros_like(window))
    s2 = draw(window)
    target = uniform((batch, 3), -0.3, 0.3)
    s2 = s2 + target[:, None, :]
    return pack_voxel_samples(s1, s2).to(dev), target.to(dev)


def train_bias_net(
    generator: torch.Generator | None = None,
    steps: int = 300,
    batch: int = 256,
    sample_pts: int = 100,
    lr: float = 1e-3,
    device: str | torch.device | None = None,
):
    """Train a BiasNet on synthetic patches on ``device`` (CUDA unless told
    otherwise); returns ``(state, losses)``.  Without a generator, one on
    the device seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    state = create_train_state(generator, lr, sample_pts, dev)
    losses = []
    for _ in range(steps):
        inputs, targets = make_patch_batch(generator, batch, sample_pts, dev)
        state, loss = train_step(state, inputs, targets)
        losses.append(float(loss))
    return state, losses


def to_serving(state: TrainState) -> BiasNet:
    """The inference :class:`BiasNet` (its encoder the CUDA kernel on the
    card) holding a trained net's weights, on the trained net's device."""
    model = state.model
    net = BiasNet(model.features, model.head)
    net.load_state_dict(bias_net_params_from_numpy(bias_net_params_to_numpy(model)))
    return net.to(next(model.parameters()).device).eval()
