"""Kernel #8's plain version, its routing and the rules it shares with the
kernel, on the CPU.

``model_fit`` takes ``model_fit_reference`` for CPU tensors, so here
``solver.model_from_sums`` must give the bits of the model fit as it stood
before the kernel, written out below as it stood, at 75x24, 150x48, fixed
radial mode, with the NDT test and with the clip-fill guard.  The kernel
commits the safeguard's extra sweeps from two flags, each an OR over every
row of a per-row bit, and keeps the state after ``sweeps + extra`` sweeps;
here that rule must give ``eigh3_planes``' safeguard on inputs where it
commits 0, 1 and 2 extra sweeps (``chip_smoke.fit_safeguard_cases``, which
the card's phase 33 runs too).  ``chip_smoke.py`` phase 33 (and
``test_torch_model_fit_card.py``) holds the CUDA kernels against the plain
version on the card.
"""

from __future__ import annotations

import inspect
import math
import re

import numpy as np
import pytest
import torch

import chip_smoke
from icet_tpu_torch import _build, graphs, solver
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu_torch.ops import gn_assembly
from icet_tpu_torch.ops import model_fit as mf
from icet_tpu_torch.ops import wls_planes
from icet_tpu_torch.ops.geometry import TWO_PI
from icet_tpu_torch.ops.moments import cov6_to_matrix, finalize_moments_planes

torch.set_num_threads(2)

CFG = ICETConfig(min_range=2.0)
SRC = (_build.CSRC / "model_fit.cu").read_text()
CASES = {"75x24": {}, "150x48": {"n_theta": 150, "n_phi": 48},
         "fixed": {"radial_mode": "fixed"}, "ndt": {"suppression": "ndt"},
         "clip_fill": {"clip_fill": 0.6}, "ndt + clip_fill": {"suppression": "ndt",
                                                              "clip_fill": 0.6}}


def _old_model_from_sums(sums, clusters, anchors, cfg):
    """``solver.model_from_sums`` before the kernel, verbatim."""
    count, mean, cov6 = finalize_moments_planes(sums, anchors)

    valid = (
        clusters.found
        & (count >= cfg.min_pts)
        & (clusters.bounds[:, 1] > cfg.min_outer_range)
    )
    eigvals, basis = wls_planes.eigh3_planes(cov6)
    if cfg.suppression == "ndt":
        lmask = mf._ndt_axis_mask(eigvals, basis, clusters.bounds, valid, cfg)
    else:
        lmask = mf._sigma_axis_mask(mean, eigvals, basis, clusters.bounds, valid, cfg)
    if cfg.clip_fill > 0.0:
        lmask = lmask * mf._clip_fill_mask(mean, eigvals, basis, clusters.bounds, valid, cfg)
    return solver.VoxelModel(
        bounds=clusters.bounds, anchors=anchors, count=count, mean=mean,
        cov=cov6_to_matrix(cov6), basis=basis, lmask=lmask, valid=valid,
    )


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
               for x, y in zip(a, b, strict=True))


@pytest.fixture(scope="module")
def scan():
    s1, _ = scan_pair_with_ground_truth(np.zeros(6), seed=5, n_beams=64, n_azimuth=1024)
    return torch.from_numpy(np.asarray(s1, np.float32))


@pytest.fixture(scope="module")
def fits(scan):
    """``model_fit``'s arguments in ``prepare_reference`` of the scan, a
    configuration each."""
    return {name: chip_smoke.fit_inputs(scan, CFG.replace(**kw)) for name, kw in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_model_from_sums_keeps_the_bits_before_the_kernel(fits, case):
    sums, clusters, anchors, cfg = fits[case]
    before = mf.model_fit.launches
    got = solver.model_from_sums(sums, clusters, anchors, cfg)
    assert mf.model_fit.launches == before  # the CPU takes the plain version
    want = _old_model_from_sums(sums, clusters, anchors, cfg)
    assert _same(got, want)
    assert sums.shape[0] == cfg.n_voxels + 1
    assert 0 < int(got.valid.sum()) and 0 < int(got.lmask.sum()) < 3 * int(got.valid.sum())


def _kernel_rule(sums, clusters, anchors, cfg, sweeps: int):
    """The model by the kernel's rule: each row's bits after ``sweeps``
    sweeps and one more, ORed a block of the launch plan at a time, then
    over the blocks; the state after ``sweeps + extra`` sweeps, without the
    safeguard.  Returns ``(model fields, extra)``."""
    _, _, cov6 = finalize_moments_planes(sums, anchors)
    A = [list(r) for r in wls_planes._sym_planes(cov6)]
    V = wls_planes._identity_planes(A[0][0])
    for _ in range(sweeps):
        A, V = wls_planes._sweep3(A, V)
    bits = []
    for _ in range(2):
        off = A[0][1] ** 2 + A[0][2] ** 2 + A[1][2] ** 2
        dg = A[0][0] ** 2 + A[1][1] ** 2 + A[2][2] ** 2
        bits.append(off > (mf.RTOL * mf.RTOL) * torch.clamp(dg, min=1e-30))
        A, V = wls_planes._sweep3(A, V)
    blocks, threads = gn_assembly.launch_plan(sums.shape[0])
    pad = blocks * threads - sums.shape[0]
    words = [torch.cat([b, b.new_zeros(pad)]).view(blocks, threads).any(1) for b in bits]
    go1, go2 = (bool(w.any()) for w in words)
    extra = 0 if not go1 else (2 if go2 else 1)
    count, mean, _ = finalize_moments_planes(sums, anchors)
    w, basis = wls_planes.eigh3_planes(cov6, sweeps=sweeps + extra, safeguard=False)
    valid = mf.model_fit_reference(sums, clusters, anchors, cfg, sweeps)[5]
    lmask = mf._sigma_axis_mask(mean, w, basis, clusters.bounds, valid, cfg)
    return (count, mean, cov6_to_matrix(cov6), basis, lmask, valid), extra


def test_safeguard_rule_equals_eigh3_planes(fits):
    """0, 1 and 2 extra sweeps, one of them held only by the sentinel and one
    only by an invalid row: the kernel's rule gives the plain version's
    bits, and the case commits the extra sweeps it names."""
    seen = set()
    for name, args, want_extra in chip_smoke.fit_safeguard_cases(*fits["75x24"]):
        sums, clusters, anchors, cfg, sweeps = args
        assert chip_smoke.fit_extra_sweeps(sums, anchors, sweeps) == want_extra, name
        got, extra = _kernel_rule(sums, clusters, anchors, cfg, sweeps)
        assert extra == want_extra, name
        assert _same(got, mf.model_fit(*args)), name
        seen.add(extra)
        if "sentinel" in name or "invalid" in name:
            # the only row that keeps the flag up is not valid
            row = sums.shape[0] - 1 if "sentinel" in name else sums.shape[0] // 2
            assert not bool(got[5][row])
    assert seen == {0, 1, 2}


def test_cpu_routes_to_the_plain_version(fits, monkeypatch):
    calls = []
    real = mf.model_fit_reference

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(mf, "model_fit_reference", spy)
    solver.model_from_sums(*fits["75x24"])
    assert len(calls) == 1


def test_other_devices_raise(fits):
    sums, clusters, anchors, cfg = fits["75x24"]
    meta = type(clusters)(*(t.to("meta") for t in clusters))
    with pytest.raises(ValueError, match="no model-fit kernel"):
        mf.model_fit(sums.to("meta"), meta, anchors.to("meta"), cfg)


def test_check_rejects_dtype_shape_and_device(fits):
    sums, clusters, anchors, _ = fits["75x24"]
    mf._check(sums, clusters, anchors)  # the layout the kernel takes
    with pytest.raises(TypeError, match="sums"):
        mf._check(sums.double(), clusters, anchors)
    with pytest.raises(TypeError, match="found"):
        mf._check(sums, type(clusters)(clusters.bounds, clusters.found.int()), anchors)
    with pytest.raises(ValueError, match="anchors"):
        mf._check(sums, clusters, anchors[:-1])
    with pytest.raises(ValueError, match="bounds"):
        mf._check(sums, type(clusters)(clusters.bounds[:, :1], clusters.found), anchors)
    with pytest.raises(ValueError, match="anchors is on meta"):
        mf._check(sums, clusters, anchors.to("meta"))


@pytest.mark.parametrize("case", ["75x24", "fixed", "notebook"])
def test_grid_arguments(case):
    """The kernel's voxel_ids parameters: each divisor a float32 reciprocal,
    the rest the config's numbers."""
    cfg = {"75x24": CFG, "fixed": CFG.replace(radial_mode="fixed"),
           "notebook": ICETConfig(n_theta=50, n_phi=15, phi_min=3 * math.pi / 8,
                                  phi_max=7 * math.pi / 8)}[case]
    args = mf.grid_args(cfg)
    assert args[:6] == (cfg.n_theta, cfg.n_phi, cfg.n_voxels, cfg.n_angular,
                        int(case == "fixed"), cfg.n_shells)
    f32 = np.float32
    for got, x in zip([args[i] for i in (7, 8, 10, 11)],
                      (TWO_PI, cfg.phi_max - cfg.phi_min, cfg.min_range,
                       math.log(cfg.shell_growth))):
        assert got == float(f32(1.0) / f32(x)) and f32(got) == got
    assert args[6] == cfg.phi_min and args[9] == cfg.min_range


def test_kernel_constants_match_the_wrapper_and_the_plain_version():
    """The scratch layout, the safeguard's extra sweeps and tolerance, the
    sweeps, read from the source and the plain version's defaults."""
    const = {k: v for k, v in re.findall(r"constexpr \w+ (k\w+) = ([^;]+);", SRC)}
    params = inspect.signature(wls_planes.eigh3_planes).parameters
    assert int(const["kMaxExtra"]) == params["max_extra"].default
    assert mf.SWEEPS == params["sweeps"].default and mf.RTOL == params["rtol"].default
    assert int(const["kState"]) == 18 and const["kScratchPerRow"] == "2 * kState"
    assert mf.SCRATCH_PER_ROW == 2 * int(const["kState"])
    assert int(re.search(r"kMaxThreads = (\d+)", SRC).group(1)) == gn_assembly.LARGE_THREADS
    assert float(const["kTwoPi"].rstrip("f")) == pytest.approx(TWO_PI, rel=1e-12)


def test_c_interface_matches_the_wrapper():
    """The C entry point's parameters, read from the source, are the
    wrapper's ctypes argument types in order (nothing here can compile it)."""
    params = re.search(r"int icet_model_fit\(([^)]*)\)", SRC).group(1)
    kinds = {"void*": "p", "int": "i", "float": "f"}
    got = []
    for p in params.split(","):
        words = p.replace("const", "").replace("*", "* ").split()
        got.append(kinds["".join(words[:-1])])
    want = {mf._P: "p", mf._I: "i", mf._F: "f"}
    assert "".join(got) == "".join(want[t] for t in mf.ARGTYPES)


def test_kernel_build_rules():
    """-fmad=false and no fast math; no atomic and no fast intrinsic in the
    source; two launches a fit, both named for the benchmark's counter; the
    wrapper's launches are counted in graphs."""
    assert "-fmad=false" in _build.NVCC_FLAGS and "--use_fast_math" not in _build.NVCC_FLAGS
    assert not re.search(r"\batomic\w*\(", SRC)
    assert not re.search(r"__(sin|cos|tan|exp|log|pow|fdivide|fsqrt)\w*\(", SRC)
    assert SRC.count("cudaLaunchKernel(") == mf.LAUNCHES
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", SRC)
    assert len(kernels) == mf.LAUNCHES and all("model_fit_kernel" in k for k in kernels)
    assert mf.model_fit in graphs.COUNTED
    assert "model_fit" in graphs.warmup_launches
