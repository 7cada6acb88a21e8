"""The port's multi-process registration
(``icet_tpu_torch/parallel/distributed.py``): two CPU processes joined over
gloo, as tests/test_distributed.py joins two JAX processes.

Each process runs ``run_distributed_registration`` on the global mesh and
checks its rows against the port's unsharded solve at the JAX package's
sharding tolerances (X within 5e-4, pred_stds rtol 0.05 / atol 1e-5, at
most 5 static-mask flips a pair) and against the ground truth; then the
pose graph with its factors sharded across the two processes against the
single-process solve (as tests/test_distributed.py:74-101).  The ranks of
one row must take the same number of iterations: a collective would hang
otherwise.  Each child is joined with a 60 s timeout and killed after it.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import json, sys
    rank, sp, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.synthetic import scan_pair_with_ground_truth
    from icet_tpu_torch.keyframe import np_pose_matrix, np_pose_to_state
    from icet_tpu_torch.parallel.distributed import (
        global_registration_mesh, init_distributed, local_numpy,
        run_distributed_registration,
    )
    from icet_tpu_torch import pose_graph as pg
    from icet_tpu_torch.solver import register_pair

    init_distributed(num_processes=2, process_id=rank, init_method=f"file://{store}",
                     device="cpu", timeout_s=50)
    mesh = global_registration_mesh(sp=sp)
    assert mesh.shape == {"dp": 2 // sp, "sp": sp}, mesh.shape
    cfg = ICETConfig(n_theta=49, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
                     n_iters=6, min_pts=20, min_range=1.0)
    # Each row registers its own frame; the ranks of a row pass the same one.
    x_true = np.array([[0.3, 0.1, 0.0, 0.0, 0.0, 0.01],
                       [-0.2, 0.15, 0.05, 0.0, 0.01, -0.02]], np.float32)[mesh.row:mesh.row + 1]
    s1, s2 = (np.stack([a]) for a in scan_pair_with_ground_truth(x_true[0], seed=100 + mesh.row))
    res, rows = run_distributed_registration(s1, s2, np.zeros((1, 6), np.float32), cfg, mesh)
    assert rows == slice(mesh.row, mesh.row + 1), rows
    X = local_numpy(res.X)
    single = register_pair(s1[0], s2[0], np.zeros(6), cfg, device="cpu")
    np.testing.assert_allclose(X[0], single.X.numpy(), rtol=0, atol=5e-4)
    np.testing.assert_allclose(local_numpy(res.pred_stds)[0], single.pred_stds.numpy(),
                               rtol=0.05, atol=1e-5)
    n = s1.shape[1] // sp
    mine = single.static_mask.numpy()[mesh.col * n:(mesh.col + 1) * n]
    assert local_numpy(res.static_mask).shape == (1, n)
    assert int((local_numpy(res.static_mask)[0] != mine).sum()) <= 5
    err = np.abs(X - x_true)
    assert (err[:, :3] < 0.03).all() and (err[:, 3:] < 0.01).all(), (X, x_true)

    # The pose graph with its factors sharded across both processes.
    K = 9
    rng = np.random.default_rng(0)  # the same graph in every process
    st = np.zeros((K, 6), np.float32)
    st[:, 0] = np.arange(K)
    st[:, 5] = 0.05 * np.arange(K)
    meas = [np_pose_to_state(np.linalg.inv(np_pose_matrix(st[k])) @ np_pose_matrix(st[k + 1]))
            + rng.normal(0, 0.01, 6) for k in range(K - 1)]
    graph = pg.PoseGraph(torch.arange(K - 1), torch.arange(1, K),
                         torch.tensor(np.stack(meas), dtype=torch.float32),
                         torch.tensor(np.tile(np.eye(6, dtype=np.float32) * 1e4, (K - 1, 1, 1))))
    s0 = (st + rng.normal(0, 0.05, (K, 6))).astype(np.float32)
    factor_mesh = global_registration_mesh(sp=1)
    single_pg = pg.optimize_poses(s0, graph, 5, device="cpu").numpy()
    dense = pg.optimize_poses_sharded(s0, graph, factor_mesh, 5).numpy()
    sparse = pg.optimize_poses_sparse_sharded(s0, graph, factor_mesh, 5, 50).numpy()
    assert np.abs(dense - single_pg).max() < 1e-3
    assert np.abs(sparse - single_pg).max() < 1e-3
    axis = mesh.axis("sp")
    print("RESULT " + json.dumps({"rank": rank, "row": mesh.row,
                                  "iterations": res.iterations.tolist(),
                                  "collectives": axis.collectives, "bytes": axis.bytes}),
          flush=True)
    """
)


def _run(tmp_path, sp: int) -> list:
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), str(sp),
                               str(tmp_path / "store")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    return results


@pytest.mark.parametrize("sp", [2, 1], ids=["dp1_sp2", "dp2_sp1"])
def test_two_process_registration(tmp_path, sp):
    r0, r1 = _run(tmp_path, sp)
    if sp == 2:
        # One row: both ranks solved the same pair from their halves.
        assert r0["row"] == r1["row"] == 0
        assert r0["iterations"] == r1["iterations"]
        # prepare: overflow count, exchange or gather, bounds gather (the
        # sharded path only), sums; then one sum an iteration.
        n_pass = 1 + r0["iterations"][0]
        assert r0["collectives"] == r1["collectives"] in (n_pass + 2, n_pass + 3)
    else:
        assert (r0["row"], r1["row"]) == (0, 1)
