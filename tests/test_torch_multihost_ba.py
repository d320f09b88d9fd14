"""The port's sharded bundle across two processes: two ranks of a gloo
group, 4 CPU shards each, one mesh of 8 shards; the CG step's sums cross
the process boundary (tests/test_multihost_ba.py's contract for the port).
Both ranks' replicated outputs agree with each other (rtol 1e-12) and with
the same three steps over a one-process mesh of 8 shards (rtol 1e-8), and
the three steps descend.  The workers (tests/torch_multihost_worker.py)
import no JAX."""

import os
import pathlib
import re
import socket
import subprocess
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_ba():
    worker = HERE / "torch_multihost_worker.py"
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(port), str(rank),
                          "2"], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, env=env, text=True)
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    def parse(out):
        found = dict(re.findall(r"CHECKSUM (\w+) ([0-9.e+-]+)", out))
        assert "inst" in found and "cam" in found, out
        return float(found["inst"]), float(found["cam"])

    c0, c1 = parse(outs[0]), parse(outs[1])
    np.testing.assert_allclose(c0, c1, rtol=1e-12)
    costs = [float(c) for _, c in re.findall(r"COST (\d+) ([0-9.e+-]+)",
                                             outs[0])]
    assert len(costs) == 3, outs[0]
    assert costs[1] < costs[0] and costs[2] < costs[1], costs

    sys.path.insert(0, str(HERE))
    import torch_multihost_worker as w
    from opensfm_tpu_torch.parallel.mesh import virtual_mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inst, cam = w.run(virtual_mesh("cpu", 8))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(c0, (np.abs(inst).sum(), np.abs(cam).sum()),
                               rtol=1e-8)


def test_worker_imports_no_jax():
    """The worker process runs with JAX hidden from its imports."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['opensfm_tpu'] = None; "
            f"sys.path.insert(0, {str(HERE)!r}); "
            "import torch_multihost_worker")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
