"""Kernel #7's plain version, its routing and the layout it shares with the
kernel, on the CPU.

``gn_eigh6`` takes ``gn_eigh6_reference`` for CPU tensors, so here
``solver.iteration_from_sums`` must give, cold and warm (both outcomes of
the warm convergence test), the bits of the iteration as it stood before the
kernel: the eigensystem, the kept axes, the pruned update and the
diagnostics, written out below as they stood.  ``chip_smoke.py`` phase 32
(and ``test_torch_gn_eigh6_card.py``) holds the CUDA kernel against the
plain version on the card.
"""

from __future__ import annotations

import inspect
import re

import numpy as np
import pytest
import torch

from icet_tpu_torch import _build, graphs, solver
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu_torch.ops import gn_eigh6 as ge
from icet_tpu_torch.ops import linalg as tlin
from icet_tpu_torch.ops.geometry import rotation_jacobian
from icet_tpu_torch.ops.gn_assembly import gn_assembly_reference

torch.set_num_threads(2)

CFG = ICETConfig(n_theta=25, n_phi=9)
SRC = (_build.CSRC / "gn_eigh6.cu").read_text()


def _old_tail(HTWH, HTWdz, X, U2_warm, cfg):
    """``iteration_from_sums`` after the assembly, before the kernel,
    verbatim: ``(X + dx, w6, keep, U2, cond_full, |dx|, dropped)``."""
    if U2_warm is None:
        w6, U2 = tlin.eigh_small(HTWH)
    else:
        w6, U2 = tlin.eigh_small_warm_safe(HTWH, U2_warm)
    cond_full = torch.abs(w6[-1]) / torch.clamp(torch.abs(w6[0]), min=1e-30)
    keep = (torch.abs(w6[-1]) <= cfg.condition_cutoff * torch.abs(w6)) & (
        torch.abs(w6) > 1e-30
    )
    inv = torch.where(keep, 1.0 / torch.where(keep, w6, torch.ones_like(w6)),
                      torch.zeros_like(w6))
    dx = U2 @ (inv * (U2.T @ HTWdz))
    return (X + dx, w6, keep, U2, cond_full, torch.linalg.norm(dx),
            torch.sum(~keep, dtype=torch.int32))


def _converged(HTWH, V0, rtol=1e-5) -> bool:
    """``eigh_small_warm_safe``'s test, read on the host."""
    A0 = V0.T @ HTWH @ V0
    _, V1 = tlin.eigh_small(A0, sweeps=1)
    R = V1.T @ A0 @ V1
    dg = torch.diagonal(R)
    off = torch.linalg.norm(R - dg[:, None] * torch.eye(6))
    return bool(off <= rtol * torch.clamp(torch.linalg.norm(dg), min=1e-30))


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
               for x, y in zip(a, b, strict=True))


@pytest.fixture(scope="module")
def pair():
    s1, s2 = scan_pair_with_ground_truth(np.array([0.3, -0.1, 0.05, 0.01, -0.01, 0.04]),
                                         seed=3, n_beams=16, n_azimuth=509)
    s1 = torch.from_numpy(np.asarray(s1, np.float32))
    s2 = torch.from_numpy(np.asarray(s2, np.float32))
    model = solver.prepare_reference(s1, CFG)
    X = torch.tensor([0.1, -0.05, 0.02, 0.01, -0.02, 0.03])
    sums = solver._sums(s2, X, model.bounds, model.anchors, CFG)
    HTWH, HTWdz = gn_assembly_reference(model, sums, X, rotation_jacobian(X[3:6]), 0, CFG)[3:5]
    return model, sums, X, HTWH, HTWdz


def _warm_bases(HTWH):
    """``(name, U2_warm)``: none (cold); the matrix's own eigenbasis (the
    warm test passes); a rotated basis (it fails: the second sweep runs)."""
    V = tlin.eigh_small(HTWH)[1]
    Q = torch.linalg.qr(torch.randn(6, 6, generator=torch.Generator().manual_seed(5)))[0]
    return [("cold", None), ("warm, converged", V), ("warm, second sweep", Q.float())]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_iteration_keeps_the_bits_before_the_kernel(pair, case):
    model, sums, X, HTWH, HTWdz = pair
    name, U2 = _warm_bases(HTWH)[case]
    if U2 is not None:
        assert _converged(HTWH, U2) == (name == "warm, converged")
    want = _old_tail(HTWH, HTWdz, X, U2, CFG)
    got = solver.iteration_from_sums(model, sums, X, 0, CFG, None, U2)
    Xn, w6, keep, _, U2n, diag, _ = got
    assert _same([Xn, w6, keep, U2n, diag[1], diag[2], diag[3]], want)
    ref = ge.gn_eigh6_reference(HTWH, HTWdz, X, U2, CFG.condition_cutoff)
    before = ge.gn_eigh6.launches
    assert _same(ge.gn_eigh6(HTWH, HTWdz, X, U2, CFG.condition_cutoff), want)
    assert _same(ref, want)
    assert ge.gn_eigh6.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("cutoff", [1e6, 1e2])
def test_pruned_axes_and_diagnostics(pair, cutoff):
    """At a cutoff of 100 axes drop; the diagnostics' types are the
    iteration's (float32, float32, int32)."""
    _, _, X, HTWH, HTWdz = pair
    Xn, w6, keep, U2, cond, dxn, dropped = ge.gn_eigh6(HTWH, HTWdz, X, None, cutoff)
    assert keep.dtype == torch.bool and dropped.dtype == torch.int32
    assert cond.dtype == dxn.dtype == torch.float32 and cond.shape == dxn.shape == ()
    assert int(dropped) == int((~keep).sum())
    assert bool(keep[-1])  # the largest axis is always kept
    if cutoff == 1e2:
        assert int(dropped) > 0
    assert torch.allclose(Xn - X, U2 @ (torch.where(keep, 1 / w6, 0) * (U2.T @ HTWdz)))


def test_cpu_routes_to_the_plain_version(pair, monkeypatch):
    _, _, X, HTWH, HTWdz = pair
    calls = []
    real = ge.gn_eigh6_reference

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(ge, "gn_eigh6_reference", spy)
    ge.gn_eigh6(HTWH, HTWdz, X, None, 1e6)
    assert len(calls) == 1


def test_other_devices_raise(pair):
    _, _, X, HTWH, HTWdz = pair
    with pytest.raises(ValueError, match="no eigensystem kernel"):
        ge.gn_eigh6(HTWH.to("meta"), HTWdz.to("meta"), X.to("meta"), None, 1e6)


def test_check_rejects_dtype_shape_and_device(pair):
    _, _, X, HTWH, HTWdz = pair
    U = torch.eye(6)
    ge._check(HTWH, HTWdz, X, U)  # the layout the kernel takes
    ge._check(HTWH, HTWdz, X, None)
    with pytest.raises(TypeError, match="HTWH"):
        ge._check(HTWH.double(), HTWdz, X, None)
    with pytest.raises(TypeError, match="U2_warm"):
        ge._check(HTWH, HTWdz, X, U.double())
    with pytest.raises(ValueError, match="HTWdz"):
        ge._check(HTWH, HTWdz[:5], X, None)
    with pytest.raises(ValueError, match="U2_warm"):
        ge._check(HTWH, HTWdz, X, U.reshape(36))
    with pytest.raises(ValueError, match="X is on meta"):
        ge._check(HTWH, HTWdz, X.to("meta"), None)


def test_unpack_views_the_kernel_layout():
    """The wrapper's views of the output words: w6, U2, X + dx, the
    condition, |dx|, the dropped count's int32 bits and keep's bytes."""
    out = torch.arange(ge.OUT_WORDS, dtype=torch.float32)
    out[ge.OUT_DROPPED:ge.OUT_DROPPED + 1].view(torch.int32)[0] = 4
    out[ge.OUT_KEEP:ge.OUT_KEEP + 2].view(torch.uint8)[:8] = torch.tensor(
        [0, 1, 1, 0, 1, 1, 7, 7], dtype=torch.uint8)
    Xn, w6, keep, U2, cond, dxn, dropped = ge.unpack(out)
    assert torch.equal(w6, torch.arange(6.0))
    assert torch.equal(U2, torch.arange(6.0, 42.0).view(6, 6))
    assert torch.equal(Xn, torch.arange(42.0, 48.0))
    assert float(cond) == 48.0 and float(dxn) == 49.0
    assert dropped.dtype == torch.int32 and dropped.shape == () and int(dropped) == 4
    assert keep.tolist() == [False, True, True, False, True, True]
    for t in (Xn, w6, keep, U2, cond, dxn, dropped):
        assert t.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()


def test_kernel_constants_match_the_wrapper_and_the_plain_version():
    """The output layout, the threads, the cold sweeps and the warm rtol,
    read from the source."""
    const = {k: v for k, v in re.findall(r"constexpr \w+ (k\w+) = ([^;]+);", SRC)}
    layout = {"kOutW": ge.OUT_W, "kOutU": ge.OUT_U, "kOutX": ge.OUT_X,
              "kOutCond": ge.OUT_COND, "kOutDxNorm": ge.OUT_DX_NORM,
              "kOutDropped": ge.OUT_DROPPED, "kOutKeep": ge.OUT_KEEP,
              "kOutWords": ge.OUT_WORDS}
    assert {k: int(const[k]) for k in layout} == layout
    assert int(const["kN"]) ** 2 == ge.THREADS and const["kThreads"] == "kN * kN"
    assert int(const["kColdSweeps"]) == inspect.signature(tlin.eigh_small).parameters[
        "sweeps"].default
    assert float(const["kWarmRtol"].rstrip("f")) == inspect.signature(
        tlin.eigh_small_warm_safe).parameters["rtol"].default


def test_round_robin_table_is_the_plain_versions():
    body = re.search(r"c_rounds\[[^=]*=\s*\{(.*?)\};", SRC, re.S).group(1)
    nums = [int(n) for n in re.findall(r"\d+", body)]
    table = [[tuple(nums[r * 6 + 2 * k:r * 6 + 2 * k + 2]) for k in range(3)]
             for r in range(len(nums) // 6)]
    assert table == tlin._round_robin_rounds(6)


def test_c_interface_matches_the_wrapper():
    """The C entry point's parameters, read from the source, are the
    wrapper's ctypes argument types in order (nothing here can compile it)."""
    params = re.search(r"int icet_gn_eigh6\(([^)]*)\)", SRC).group(1)
    kinds = {"void*": "p", "int": "i", "float": "f"}
    got = []
    for p in params.split(","):
        words = p.replace("const", "").replace("*", "* ").split()
        got.append(kinds["".join(words[:-1])])
    want = {ge._P: "p", ge._F: "f"}
    assert "".join(got) == "".join(want[t] for t in ge.ARGTYPES)


def test_kernel_build_rules():
    """-fmad=false and no fast math; no atomic and no fast intrinsic in the
    source; the wrapper's launches are counted in graphs."""
    assert "-fmad=false" in _build.NVCC_FLAGS and "--use_fast_math" not in _build.NVCC_FLAGS
    assert not re.search(r"\batomic\w*\(", SRC)
    assert not re.search(r"__(sin|cos|tan|exp|log|pow|fdivide|fsqrt)\w*\(", SRC)
    assert ge.gn_eigh6 in graphs.COUNTED
    assert "gn_eigh6" in graphs.warmup_launches
