"""CPU process groups for testing the parallel paths without a card (the
port's counterpart of utils/virtual_mesh.py, which gives JAX n virtual
CPU devices in one process).

`spawn_cpu_group(n, fn, *args, timeout_s=...)` runs `fn(*args)` in n
fresh interpreters, ranks 0..n-1 of one gloo process group (a file
store in a temporary directory, so concurrent groups never share a
port), and returns their results in rank order. `fn` must be importable
by name (a module-level function of a module the children can import)
and its arguments and result picklable. Each child imports only what
`fn`'s module imports: a rank never imports JAX unless `fn` does.

A rank that fails fails the call, with the tail of its output; when
`timeout_s` passes, every rank still running is killed and the call
raises, so a hung collective fails a test instead of hanging the suite.
Each child destroys its process group in `finally`.

    python -m megatron_llm_tpu_torch.utils.virtual_mesh <dir> <rank>

is a child's command line (what `spawn_cpu_group` starts).
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def spawn_cpu_group(n: int, fn, *args, timeout_s: float = 120.0,
                    threads: int = 1) -> list:
    """[fn(*args) on rank r for r in range(n)] from n gloo CPU ranks."""
    with tempfile.TemporaryDirectory(prefix="cpu_group_") as d:
        d = Path(d)
        with open(d / "spec.pkl", "wb") as f:
            pickle.dump({"module": fn.__module__, "name": fn.__qualname__,
                         "args": args, "n": n, "threads": threads,
                         "sys_path": [p for p in sys.path if p]}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        logs = [open(d / f"log{r}.txt", "w") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "megatron_llm_tpu_torch.utils.virtual_mesh",
             str(d), str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
            env=env, cwd=str(REPO)) for r in range(n)]
        try:
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    r = bad[0]
                    raise RuntimeError(
                        f"rank {r} of {n} exited with {codes[r]}:\n"
                        f"{_tail(d / f'log{r}.txt')}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} CPU ranks ran past {timeout_s} s; killed. "
                        f"rank 0:\n{_tail(d / 'log0.txt')}")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for f in logs:
                f.close()
        out = []
        for r in range(n):
            with open(d / f"out{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text()[-n:]
    except OSError:
        return ""


def _child(d: str, rank: int) -> None:
    d = Path(d)
    with open(d / "spec.pkl", "rb") as f:
        spec = pickle.load(f)
    for p in reversed(spec["sys_path"]):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(spec["threads"])
    n = spec["n"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    fn = importlib.import_module(spec["module"])
    for part in spec["name"].split("."):
        fn = getattr(fn, part)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=n)
    try:
        result = fn(*spec["args"])
    finally:
        dist.destroy_process_group()
    with open(d / f"out{rank}.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(d / f"out{rank}.tmp", d / f"out{rank}.pkl")


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
