"""Run a function on N gloo ranks of the CPU, for the port's mesh tests.

``run(fn, world, tmp)`` spawns ``world`` processes (``spawn``, so nothing of
the caller's state is shared), joins them into one gloo group over a
``file://`` store under ``tmp`` (no fixed port: safe beside other test
workers), calls ``fn(rank, world, *args)`` on each with one torch thread,
and returns each rank's result (``torch.save``d by the rank). A rank that
raises fails the call with its traceback; every collective must be called
by every rank, or the others hang until ``timeout``.
"""
import os
import pathlib
import traceback

import torch
import torch.multiprocessing as mp


def _entry(rank, world, store, fn, args, out):
    torch.set_num_threads(1)
    try:
        from repro_torch.launch.mesh import init_group
        init_group("gloo", rank=rank, world_size=world,
                   init_method=f"file://{store}")
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        pathlib.Path(out, f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, world: int, tmp, *args, timeout: float = 600.0) -> list:
    out = pathlib.Path(tmp) / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    store = pathlib.Path(tmp) / "store"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, str(store), fn, args, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    errors = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            errors.append(f"rank {r}: timed out after {timeout} s")
        elif p.exitcode != 0:
            err = out / f"rank{r}.err"
            errors.append(f"rank {r}: exit {p.exitcode}\n"
                          + (err.read_text() if err.exists() else ""))
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
