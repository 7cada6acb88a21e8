"""The perspective-shift bias network (``icet_tpu/models/bias_net.py``),
inference only.

A PointNet-style per-voxel regressor: each voxel's input is ``(2S, 4)``, the
S points sampled from each of two scans, centred on their joint mean, with
a scan-id channel (-1 / +1).  A shared per-point encoder (three
Dense+LayerNorm+ReLU stages of 64, 128 and 256 features, in bf16)
max-pools to a 256-wide code; a float32 head (128, 64 -> 3) predicts the
voxel's inter-scan translation.

One forward follows the JAX package's fused semantics (``apply_bias_net``
with ``fused=True``), stage 1 included: the encoder and pool are the CUDA
kernel of ``ops/bias_encoder.py`` on the card and its plain version on the
CPU.  Training (``train_bias_net``, ``models/train_data.py``) is not ported.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from icet_tpu_torch.convert import bias_net_params_from_numpy
from icet_tpu_torch.ops.bias_encoder import (  # noqa: F401  (re-exported)
    FEATURES,
    IN_DIM,
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
    ``(in, out)`` layout; see :func:`convert.bias_net_params_from_numpy`."""

    def __init__(self, features: tuple = FEATURES, head: tuple = HEAD):
        super().__init__()
        self.features = tuple(features)
        self.head = tuple(head)
        dims = (IN_DIM,) + self.features
        for i, (c, f) in enumerate(zip(dims[:-1], dims[1:])):
            self.register_buffer(f"enc{i}_w", torch.zeros(c, f))
            self.register_buffer(f"enc{i}_w_bf16", torch.zeros(c, f, dtype=torch.bfloat16))
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
