"""Two processes of ``train_gmpi_torch.py --multihost --device cpu`` on
localhost, mirroring ``tests/test_multihost.py``.

Each child (``tests/_torch_dist_child.py``, job ``cli``) sets the
environment that ``python -m torch.distributed.run`` would (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR`` / ``MASTER_PORT`` from the
test, a port from a bound socket) and calls ``train_gmpi_torch.main`` on the
tiny config over a 16^2 fixture dataset of 7 usable images: a data mesh of
2, a global batch of 4 (2 a rank), 2 steps.  The loader shards are disjoint
and complete with DistributedSampler padding (7 images -> 4 a shard, one
wrapped around), the CLI made a ``gloo`` group (the CPU's backend), only
rank 0 writes checkpoints, the ranks end with
identical parameters (``check_replica_consistency(atol=0)`` in the children,
bitwise G here), and neither child imported JAX.
"""

import os
import socket

import torch

from tests import _torch_dist_child as child
from tests.test_torch_train_loop import _ffhq16


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cli(tmp_path):
    import numpy as np

    data = _ffhq16(tmp_path, n=8)  # one image fail-listed: 7 usable
    out = tmp_path / "run"
    argv = data + ["--output_dir", str(out), "--device", "cpu", "--multihost",
                   "--total_iters", "2", "--seed", "3",
                   "--sample_interval", "1", "--model_save_interval", "1"]
    np.savez(tmp_path / "inputs.npz", argv=np.array(argv, dtype=object))
    results = child.spawn("cli", 2, str(tmp_path), timeout=400,
                          env={"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())})

    # 1. the CLI's process group on the CPU is gloo's; the ranks' shards are
    # disjoint and complete, padded to equal size
    assert [r["backends"] for r in results] == [["gloo"], ["gloo"]]
    shards = [r["shards"] for r in results]
    assert all(len(s) == 1 for s in shards)
    (id0, n0, b0, idx0), (id1, n1, b1, idx1) = shards[0][0], shards[1][0]
    assert (id0, id1, n0, n1, b0, b1) == (0, 1, 2, 2, 2, 2)
    assert len(idx0) == len(idx1) == 4
    assert set(idx0) | set(idx1) == set(range(7))
    assert len(idx0 + idx1) - len(set(idx0 + idx1)) == 1  # the one pad sample

    # 2. rank 0 alone writes checkpoints (steps 1 and the final 2)
    assert len(results[0]["saves"]) == 2 and results[1]["saves"] == []
    assert open(out / "checkpoints" / "latest").read() == "step_00000002"
    assert sorted(os.listdir(out)) == ["checkpoints", "config.json", "metrics.jsonl", "snaps",
                                       "tensorboard"]
    assert len(open(out / "metrics.jsonl").read().splitlines()) == 1  # rank 0's step 0

    # 3. identical replicas, and no JAX in the children
    assert results[0]["step"] == results[1]["step"] == 2
    for k, v in results[0]["G"].items():
        assert torch.equal(v, results[1]["G"][k]), k
    assert results[0]["modules"] == results[1]["modules"] == []
