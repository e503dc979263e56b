"""Block-size sweep of the fused walk kernel at the benchmark's shapes.

For each shape of ``bench.py`` (full, short, accuracy) and each
``pallas_block_rows`` (warps follow at one walker per thread,
``ops.pallas_walk.num_warps``), compiles the kernel solve, then times
``REPS`` solves; the configurations run in one order and then
in reverse, so a drift of the card's clock over the sweep shows up as a
disagreement between the two passes. Prints one line per configuration
and pass, with the card's name and power limit first.

usage: python tools/kernel_sweep.py [SHAPE ...]   (on the GPU)
"""
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = [1, 2, 4]
REPS = {"full": 3, "short": 5, "accuracy": 3}


def main(shapes):
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    import jax
    import jax.numpy as jnp

    import bench
    from dcrmontecarlo_tpu.ops.pallas_walk import num_warps

    bench.configure_compile_cache()
    cases = {"full": bench.full_case, "short": bench.short_case,
             "accuracy": bench.accuracy_case}
    for name in shapes:
        for order in (CONFIGS, CONFIGS[::-1]):
            for rows in order:
                solver, pts, n_walks, max_steps, eps = cases[name](
                    backend="pallas", pallas_block_rows=rows)
                pts = jnp.asarray(pts)
                fn = solver._build_solve_fn(len(pts), n_walks, max_steps,
                                            eps)
                jax.block_until_ready(fn(pts, jax.random.PRNGKey(0)))
                ts = []
                for rep in range(REPS[name]):
                    t0 = time.perf_counter()
                    out = fn(pts, jax.random.PRNGKey(rep + 1))
                    steps = float(out.total_steps)
                    ts.append(time.perf_counter() - t0)
                print(f"{name} rows={rows} warps={num_warps(rows)} "
                      f"median_s={np.median(ts):.6f} "
                      f"steps_per_s={steps / np.median(ts):.6g}",
                      flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["full", "short", "accuracy"])
