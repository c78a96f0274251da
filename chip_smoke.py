"""Smoke test of the grain engine on one NVIDIA GPU, through its entry points.

Run from the root of a checkout:

    python chip_smoke.py           # one GPU: phases 1-4
    python chip_smoke.py --multi   # four GPUs: the mesh phase only

Phases (one process; the card is never opened by a second one):

1. device: the card's name and power limit from nvidia-smi; JAX must run on
   a GPU (JAX falls back to the CPU with only a warning, so no GPU is a
   failure);
2. goldens: every vendored golden case reproduces its sha256 -- the 48 CLI
   cases through ``cli.main``, the 6 engine-level 4:2:2/4:4:4 cases through
   ``GrainPipeline.run_file``;
3. full width: 16 frames of 3840x2160 made from a seed, through ``cli.main``
   (SEI-FF default, SEI-AR, AFGS1, 8-bit 4:2:0 with --outdepth 8) and
   ``GrainPipeline.run_file`` (4:2:2 and 4:4:4 with luma-only configs, which
   the CLI's built-in default config rejects); the first 2 frames of each
   must equal the plain engine (ops/grain_jnp.py) run on the CPU device of
   this process, byte for byte;
4. kernel: at 4K batch 8, the fused Triton kernel against grain_jnp on the
   card for every plane geometry, its ``memory_analysis()``, the step time of
   the kernel, grain_fast and grain_jnp, and run_file frames/s per engine.

``--multi``: the Triton kernel sharded over make_mesh(4, 1) and
make_mesh(2, 2) at 4K, 8 frames, SEI-FF and AFGS1, must equal the
single-device kernel on device 0 byte for byte, with the shards on four
distinct devices.

Times are wall-clock on the host and informational; every line that holds
one also names the card.  Any failure exits nonzero before the last line,
which is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
H4K, W4K = 2160, 3840
FRAMES_4K = 16
BATCH = 8
RUN_FILE_PAIRS = 8


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError as e:
        raise SmokeFailure(f"nvidia-smi: {e}")
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


# -- phase 2: goldens ---------------------------------------------------

def phase_goldens(tmp):
    from gen_golden import FMT_NAMES, cli_args
    from gen_input import make_input_yuv
    from test_format_golden import _afgs1_cfg, _sei_cfg
    from versatilefilmgrain_tpu.cli import main as cli_main
    from versatilefilmgrain_tpu.pipeline import GrainPipeline

    golden = json.load(open(os.path.join(REPO, "tests", "golden",
                                         "checksums.json")))
    for name in sorted(golden):
        case = golden[name]["case"]
        inp = os.path.join(tmp, "in_%dx%d_%db_%s_%df.yuv" % (
            case["w"], case["h"], case["depth"], FMT_NAMES[case["fmt"]],
            case["in_frames"]))
        if not os.path.exists(inp):
            make_input_yuv(inp, case["w"], case["h"], case["depth"],
                           case["fmt"], case["in_frames"])
        out = os.path.join(tmp, "golden_out.yuv")
        rc = cli_main(["vfgs"] + cli_args(case, inp, out))
        check(rc == 0, f"golden {name}: cli exit {rc}")
        check(sha256(out) == golden[name]["sha256"],
              f"golden {name}: output differs from the reference")
    print(f"goldens: {len(golden)} CLI cases byte-equal", flush=True)

    fgold = json.load(open(os.path.join(REPO, "tests", "golden",
                                        "format_checksums.json")))
    for name in sorted(fgold):
        e = fgold[name]
        fmt = 0 if e["suby"] == 2 else (1 if e["subx"] == 2 else 2)
        inp = os.path.join(tmp, f"fmt_{name}.yuv")
        make_input_yuv(inp, e["w"], e["h"], e["depth"], fmt, e["frames"])
        out = os.path.join(tmp, "golden_out.yuv")
        kw = (dict(initial_sei=_sei_cfg()) if e["mode"] == "sei"
              else dict(initial_afgs1=_afgs1_cfg()))
        pipe = GrainPipeline(e["w"], e["h"], e["depth"], fmt, **kw)
        check(pipe.engine == "triton", f"auto picked {pipe.engine}")
        n = pipe.run_file(inp, out, frames=e["frames"], batch=2)
        check(n == e["frames"], f"format golden {name}: {n} frames")
        check(sha256(out) == e["sha256"],
              f"format golden {name}: output differs from the reference")
    print(f"goldens: {len(fgold)} engine-level 4:2:2/4:4:4 cases byte-equal",
          flush=True)


# -- phase 3: full width ------------------------------------------------

def _ref_frames(cpu, inp, nbytes, **kw):
    """First 2 frames from the plain engine on the CPU device."""
    import jax
    from versatilefilmgrain_tpu.pipeline import GrainPipeline

    odepth = kw.pop("odepth", 0)
    buf = io.BytesIO()
    with jax.default_device(cpu), open(inp, "rb") as fs:
        pipe = GrainPipeline(W4K, H4K, engine="ref", **kw)
        pipe.run(fs, buf, frames=2, odepth=odepth)
    data = buf.getvalue()
    check(len(data) == nbytes, f"reference wrote {len(data)} bytes")
    return data


def phase_full_width(tmp, card):
    import jax
    from gen_input import make_input_yuv
    from test_format_golden import _afgs1_cfg
    from test_pipeline_formats import _luma_only_sei
    from versatilefilmgrain_tpu.cli import main as cli_main
    from versatilefilmgrain_tpu.pipeline import GrainPipeline
    from versatilefilmgrain_tpu.utils import yuv

    cpu = jax.devices("cpu")[0]
    cfg = os.path.join(REPO, "tests", "golden", "cfg")
    inputs = {}

    def src(depth, fmt):
        if (depth, fmt) not in inputs:
            path = os.path.join(tmp, f"in4k_{depth}b_{fmt}.yuv")
            make_input_yuv(path, W4K, H4K, depth, fmt, FRAMES_4K, seed=2024)
            inputs[depth, fmt] = path
        return inputs[depth, fmt]

    cases = [
        ("SEI-FF 4:2:0 10-bit (default cfg)", 10, 0, [], dict),
        ("SEI-AR 4:2:0 10-bit", 10, 0,
         ["-c", os.path.join(cfg, "fgs_sei_ar_test1.cfg")], dict),
        ("AFGS1 4:2:0 10-bit", 10, 0,
         ["-c", os.path.join(cfg, "fgs_afgs1_test1.cfg")], dict),
        ("SEI-FF 4:2:0 8-bit --outdepth 8", 8, 0, ["--outdepth", "8"], dict),
        ("SEI-FF luma-only 4:2:2 10-bit", 10, 1, None,
         lambda: dict(initial_sei=_luma_only_sei())),
        ("AFGS1 luma-only 4:4:4 10-bit", 10, 2, None,
         lambda: dict(initial_afgs1=_afgs1_cfg())),
    ]
    # The library runs get a fresh config object each: pipelines adjust
    # their initial config in place.
    for name, depth, fmt, args, lib_kw in cases:
        inp = src(depth, fmt)
        out = os.path.join(tmp, "out4k.yuv")
        t0 = time.perf_counter()
        if args is not None:
            rc = cli_main(["vfgs", "-w", str(W4K), "-h", str(H4K), "-b",
                           str(depth), "-f", ("420", "422", "444")[fmt],
                           "--batch", str(BATCH)] + args + [inp, out])
            check(rc == 0, f"{name}: cli exit {rc}")
        else:
            pipe = GrainPipeline(W4K, H4K, depth, fmt, **lib_kw())
            check(pipe.engine == "triton", f"auto picked {pipe.engine}")
            n = pipe.run_file(inp, out, batch=BATCH)
            check(n == FRAMES_4K, f"{name}: {n} frames")
        dt = time.perf_counter() - t0
        odepth = 8 if "--outdepth" in (args or []) else depth
        fb = yuv.frame_bytes(W4K, H4K, odepth, fmt)
        check(os.path.getsize(out) == FRAMES_4K * fb,
              f"{name}: output holds {os.path.getsize(out)} bytes")
        ref_kw = dict(depth=depth, fmt=fmt, odepth=odepth, **lib_kw())
        if args and "-c" in args:
            ref_kw["configs"] = [args[args.index("-c") + 1]]
        ref = _ref_frames(cpu, inp, 2 * fb, **ref_kw)
        with open(out, "rb") as f:
            got = f.read(2 * fb)
        check(got == ref, f"{name}: first 2 frames differ from grain_jnp "
                          f"on the CPU")
        print(f"4K {name}: {FRAMES_4K} frames byte-equal to grain_jnp (CPU) "
              f"on the first 2; {FRAMES_4K / dt:.1f} fps wall-clock incl. "
              f"compile [{card}]", flush=True)
        if (depth, fmt) != (10, 0):     # phase 4 reuses only 10-bit 4:2:0
            os.remove(inputs.pop((depth, fmt)))
    return inputs


# -- phase 4: kernel ------------------------------------------------------

def _inputs(depth, csub, F, H, W, seed=0):
    import jax
    import jax.numpy as jnp
    sx, sy = csub
    dt = jnp.uint8 if depth == 8 else jnp.uint16
    k = jax.random.split(jax.random.key(seed), 3)
    return tuple(jax.random.randint(kk, shape, 0, 1 << depth).astype(dt)
                 for kk, shape in zip(k, ((F, H, W), (F, H // sy, W // sx),
                                          (F, H // sy, W // sx))))


def _bases(regs, F, R, C):
    import jax.numpy as jnp
    from __graft_entry__ import _frame_bases
    b, bu = _frame_bases(regs, F, R, C)
    return jnp.asarray(b), jnp.asarray(bu)


def _engine_steps(regs, H, W):
    """{name: step(y, u, v, bases, bases_up)} for the three engines."""
    import functools
    import jax
    import jax.numpy as jnp
    from versatilefilmgrain_tpu.ops import grain_triton
    from versatilefilmgrain_tpu.ops.grain_fast import (add_grain_frame_fast,
                                                       fast_args,
                                                       fast_tables)
    from versatilefilmgrain_tpu.ops.grain_jnp import add_grain_frame

    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)
    tri = grain_triton.make_batched_step(**geo)
    ta = grain_triton.table_args(grain_triton.triton_tables(regs))
    fast = jax.jit(jax.vmap(functools.partial(
        add_grain_frame_fast, height=H, width=W, **geo),
        in_axes=(0,) * 5 + (None,) * 11))
    fa = fast_args(fast_tables(regs))
    ref = jax.jit(jax.vmap(functools.partial(
        add_grain_frame, height=H, width=W, **geo),
        in_axes=(0,) * 5 + (None,) * 8))
    dp = regs.device_params()
    ra = (jnp.asarray(dp["pattern"]), jnp.asarray(dp["sluts"]),
          jnp.asarray(dp["pluts"]), dp["scale_shift"], dp["y_min"],
          dp["y_max"], dp["c_min"], dp["c_max"])
    return {"triton": (lambda *a: tri(*a, *ta), tri, ta),
            "grain_fast": (lambda *a: fast(*a, *fa), None, None),
            "grain_jnp": (lambda *a: ref(*a, *ra), None, None)}


def _step_seconds(fn, args, n=20):
    """Median of 3 windows of n back-to-back steps, ended by a block."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(n)]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / n)
        del outs
    return sorted(times)[1]


def phase_kernel(card, inputs, tmp):
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _afgs1_regs, _sei_regs
    from versatilefilmgrain_tpu.pipeline import GrainPipeline

    H, W = H4K, W4K
    R, C = H // 16, W // 16
    geometries = [("SEI-FF 4:2:0 10-bit (chroma 8x8)", _sei_regs, 10, (2, 2)),
                  ("SEI-FF 4:2:0 8-bit", _sei_regs, 8, (2, 2)),
                  ("SEI-FF 4:2:2 10-bit (chroma 16x8)", _sei_regs, 10, (2, 1)),
                  ("SEI-FF 4:4:4 10-bit (chroma 16x16)", _sei_regs, 10, (1, 1)),
                  ("AFGS1 4:2:0 10-bit", _afgs1_regs, 10, (2, 2)),
                  ("AFGS1 4:4:4 8-bit", _afgs1_regs, 8, (1, 1))]
    for name, mk, depth, csub in geometries:
        regs = mk(depth, csub)
        x = _inputs(depth, csub, BATCH, H, W)
        b = _bases(regs, BATCH, R, C)
        steps = _engine_steps(regs, H, W)
        out = steps["triton"][0](*x, *b)
        ref = steps["grain_jnp"][0](*x, *b)
        for p in range(3):
            check(bool(jnp.array_equal(out[p], ref[p])),
                  f"kernel {name}: plane {p} differs from grain_jnp")
        print(f"kernel {name}: 4K batch {BATCH} bit-exact vs grain_jnp on "
              f"the card", flush=True)

    regs = _sei_regs(10, (2, 2))
    x = _inputs(10, (2, 2), BATCH, H, W)
    b = _bases(regs, BATCH, R, C)
    steps = _engine_steps(regs, H, W)
    _, tri, ta = steps["triton"]
    print(f"kernel memory_analysis (4K batch {BATCH}): "
          f"{tri.lower(*x, *b, *ta).compile().memory_analysis()}", flush=True)
    for name in ("triton", "grain_fast", "grain_jnp"):
        t = _step_seconds(steps[name][0], x + b)
        print(f"step {name}: {t * 1e3:.3f} ms per 4K 10-bit 4:2:0 batch of "
              f"{BATCH} = {BATCH / t:.1f} fps, frames resident [{card}]",
              flush=True)

    # End to end, warm, in turns (triton, fast, fast, triton, ...); -v
    # stage times go to stderr.
    inp = inputs[10, 0]
    pipes, outs, fps = {}, {}, {"triton": [], "fast": []}
    for engine in fps:
        pipes[engine] = GrainPipeline(W, H, 10, 0, engine=engine)
        pipes[engine].run_file(inp, os.path.join(tmp, "rf.yuv"),
                               batch=BATCH)          # compile + warm
    for rep in range(RUN_FILE_PAIRS):
        for engine in (("triton", "fast") if rep % 2 == 0
                       else ("fast", "triton")):
            out = os.path.join(tmp, f"rf_{engine}.yuv")
            t0 = time.perf_counter()
            n = pipes[engine].run_file(inp, out, batch=BATCH, verbose=True)
            fps[engine].append(n / (time.perf_counter() - t0))
            outs[engine] = sha256(out)
    check(outs["triton"] == outs["fast"], "run_file engines disagree")
    for engine, v in fps.items():
        print(f"run_file {engine}: {FRAMES_4K} frames 4K 10-bit 4:2:0, warm,"
              f" fps per run {[round(x, 2) for x in v]}, median "
              f"{sorted(v)[len(v) // 2]:.2f} [{card}]", flush=True)


# -- four cards -----------------------------------------------------------

def phase_multi(card, H=H4K, W=W4K, frames=BATCH, interpret=False):
    """Mesh phase; small shapes with interpret=True rehearse it on CPUs."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from __graft_entry__ import _afgs1_regs, _sei_regs
    from versatilefilmgrain_tpu.ops import grain_triton
    from versatilefilmgrain_tpu.parallel import mesh as pmesh

    devices = jax.devices()
    check(len(devices) >= 4, f"--multi needs 4 devices, found "
                             f"{len(devices)}")
    R, C = -(-H // 16), -(-W // 16)
    for name, mk in (("SEI-FF", _sei_regs), ("AFGS1", _afgs1_regs)):
        regs = mk(10, (2, 2))
        ta = grain_triton.table_args(grain_triton.triton_tables(regs))
        # Host arrays: the single-device step runs on device 0, the mesh
        # step places its own shards.
        x = [np.asarray(p) for p in _inputs(10, (2, 2), frames, R * 16,
                                             C * 16)]
        b = [np.asarray(a) for a in _bases(regs, frames, R, C)]
        single = grain_triton.add_grain_batch(
            *x, *b, *ta, bs=2, csubx=2, csuby=2, interpret=interpret)
        single = [np.asarray(p) for p in single]
        for shape in ((4, 1), (2, 2)):
            m = pmesh.make_mesh(*shape, devices=devices[:4])
            step = pmesh.make_grain_step(m, bs=2, csubx=2, csuby=2,
                                         engine="triton",
                                         interpret=interpret)
            # Block rows padded to a multiple of the tile axis (the lattice
            # of the real rows does not depend on the padding).
            rp = -(-R // shape[1]) * shape[1]
            xp = [np.pad(p, ((0, 0), (0, (rp - R) * p.shape[1] // R),
                             (0, 0)), mode="edge") for p in x]
            out = step(*xp, *b, *ta)
            jax.block_until_ready(out)
            used = {s.device for o in out for s in o.addressable_shards}
            check(len(used) == 4, f"{name} mesh {shape}: shards on "
                                  f"{len(used)} devices")
            for p in range(3):
                got = np.asarray(out[p])[:, :single[p].shape[1]]
                check(np.array_equal(got, single[p]),
                      f"{name} mesh {shape}: plane {p} differs from the "
                      f"single-device kernel")
            print(f"multi {name} mesh(data={shape[0]},tile={shape[1]}): "
                  f"{frames} frames {W}x{H} byte-identical to device 0, "
                  f"shards on 4 devices [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "versatilefilmgrain_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    for sub in ("", "tools", "tests"):
        sys.path.insert(0, os.path.join(REPO, sub))
    from versatilefilmgrain_tpu.utils.compile_cache import \
        setup_compile_cache
    setup_compile_cache()
    import jax

    try:
        check(jax.default_backend() == "gpu",
              f"JAX runs on {jax.default_backend()!r}, not a GPU")
        card = card_line()
        print(card, flush=True)
        devices = jax.devices()
        check(len(devices) >= 1, "no GPU device")
        print(f"device: {devices[0].platform} {devices[0].device_kind} "
              f"x{len(devices)}", flush=True)
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory() as tmp:
            warnings.simplefilter("always")
            if args.multi:
                phase_multi(card)
            else:
                phase_goldens(tmp)
                inputs = phase_full_width(tmp, card)
                phase_kernel(card, inputs, tmp)
        donated = [str(w.message) for w in caught
                   if "donated buffers were not usable" in str(w.message)]
        check(not donated, f"unusable donation: {donated[:1]}")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
