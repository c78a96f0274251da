"""Benchmark: 4K 10-bit 4:2:0 grain synthesis, frames/s on one GPU.

Prints ONE JSON line on stdout:
  {"metric": "fps_4k_10b_420", "value": N, "unit": "frames/s",
   "vs_baseline": N / reference_fps or null, "device": {...}, "card": ...}

The default engine's batched step (the one ``GrainPipeline.run_file``
dispatches) runs on 8 frames resident in device memory with the default SEI
config; its output must equal the XLA engine's byte for byte.  For scale,
stderr also gets the XLA engine and a device copy of the same bytes (one
read and one write per sample, the least traffic any engine moves).  Each
time is the median of 3 windows of back-to-back steps ended by
``block_until_ready``, and every line names the card and its power limit.

``--reference PATH`` names a ``vfgs`` binary built from the reference C
model; its single-threaded frames/s over the same frames gives
``vs_baseline``.  Without it, or if it fails, ``vs_baseline`` is null.

A run that finds no GPU fails instead of reporting.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 2160, 3840
FRAMES_BATCH = 8
STEPS = 20          # back-to-back steps per timing window
FRAME_BYTES = (W * H * 3 // 2) * 2  # uint16 planes in (and out)


def step_seconds(fn, args) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(STEPS)]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / STEPS)
        del outs
    return sorted(times)[1]


def bench_reference(vfgs: str) -> float | None:
    """Reference binary frames/s over 3 frames, best of 3, or None."""
    nframes = 3
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "out.yuv")
        np.random.default_rng(42).integers(
            0, 1024, nframes * FRAME_BYTES // 2, dtype=np.uint16).tofile(inp)
        args = [vfgs, "-w", str(W), "-h", str(H), "-b", "10", "-n",
                str(nframes), inp, out]
        try:
            subprocess.run(args, check=True, capture_output=True)
            dt = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                subprocess.run(args, check=True, capture_output=True)
                dt = min(dt, time.perf_counter() - t0)
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"bench: reference binary failed: {e}", file=sys.stderr)
            return None
    return nframes / dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", help="path of a reference vfgs binary")
    args = ap.parse_args(argv)

    from versatilefilmgrain_tpu.utils.compile_cache import \
        setup_compile_cache
    setup_compile_cache()
    import jax
    import jax.numpy as jnp
    from chip_smoke import card_line
    from __graft_entry__ import _frame_bases
    from versatilefilmgrain_tpu.ops.grain_fast import (add_grain_frame_fast,
                                                       fast_args,
                                                       fast_tables)
    from versatilefilmgrain_tpu.pipeline import GrainPipeline

    if jax.default_backend() != "gpu":
        print(f"bench: JAX runs on {jax.default_backend()!r}, not a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    dev = jax.devices()[0]
    tag = f"[{dev.device_kind}; {card}]"

    pipe = GrainPipeline(W, H, 10, 0)
    regs = pipe.regs
    R, C = H // 16, W // 16
    F = FRAMES_BATCH
    bases, bases_up = _frame_bases(regs, F, R, C)
    rng = np.random.default_rng(0)
    state = tuple(jnp.asarray(rng.integers(0, 1024, shape, dtype=np.uint16))
                  for shape in ((F, H, W), (F, H // 2, W // 2),
                                (F, H // 2, W // 2)))
    cargs = (jnp.asarray(bases), jnp.asarray(bases_up))

    step, tables = pipe._batched_step(), pipe._tables()
    fast = jax.jit(jax.vmap(functools.partial(
        add_grain_frame_fast, height=H, width=W, bs=2, csubx=2, csuby=2),
        in_axes=(0,) * 5 + (None,) * 11))
    fa = fast_args(fast_tables(regs))
    out = step(*state, *cargs, *tables)
    ref = fast(*state, *cargs, *fa)
    for p in range(3):
        if not bool(jnp.array_equal(out[p], ref[p])):
            print(f"bench: engine {pipe.engine} differs from the XLA engine "
                  f"in plane {p}", file=sys.stderr)
            return 1

    @jax.jit
    def copy_step(y, u, v):
        return y ^ jnp.uint16(1), u ^ jnp.uint16(1), v ^ jnp.uint16(1)

    t = step_seconds(lambda *a: step(*a, *cargs, *tables), state)
    t_fast = step_seconds(lambda *a: fast(*a, *cargs, *fa), state)
    t_copy = step_seconds(copy_step, state)
    fps = F / t
    print(f"bench: {pipe.engine} {1e3 * t:.3f} ms/step = {fps:.1f} fps "
          f"({fps * 2 * FRAME_BYTES / 1e9:.0f} GB/s in+out) | xla "
          f"{F / t_fast:.1f} fps | device copy {F / t_copy:.1f} fps "
          f"({F * 2 * FRAME_BYTES / t_copy / 1e9:.0f} GB/s) | 4K 10-bit "
          f"4:2:0, batch {F}, frames resident {tag}", file=sys.stderr)

    ref_fps = bench_reference(args.reference) if args.reference else None
    if ref_fps:
        print(f"bench: reference vfgs {ref_fps:.2f} fps on the host "
              f"(single thread)", file=sys.stderr)
    print(json.dumps({
        "metric": "fps_4k_10b_420",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / ref_fps, 2) if ref_fps else None,
        "engine": pipe.engine,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
