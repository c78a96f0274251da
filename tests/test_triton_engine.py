"""The fused Triton kernel must match the fast (XLA) engine bit-exactly.

Runs the kernel in interpret mode on the CPU test mesh; the compiled GPU
path is exercised by chip_smoke.py (same kernel code, interpret=False).
Covers SEI-FF / SEI-AR / AFGS1 configs, 4:2:0 / 4:2:2 / 4:4:4, 8/10-bit,
vertical overlap across block rows and frames, random configs, plus the
pipeline-level ``engine="triton"`` wiring.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from versatilefilmgrain_tpu.ops import grain_triton, lfsr
from versatilefilmgrain_tpu.ops.grain_fast import (add_grain_frame_fast_jit,
                                                   fast_args, fast_tables)
from versatilefilmgrain_tpu.ops.grain_triton import (add_grain_batch,
                                                     table_args,
                                                     triton_tables)

from test_fast_engine import _regs_for


def _bases(regs, frames, R, C):
    bases, bases_up = [], []
    for f in frames:
        e0 = lfsr.frame_base_exponent(f, R, C)
        bases.append(int(lfsr.advance(np.uint32(regs.seed_state), e0)))
        bases_up.append(int(lfsr.advance(np.uint32(regs.seed_state), e0 - C))
                        if e0 else bases[-1])
    return bases, bases_up


def _triton(regs, y, u, v, bases, bases_up, *, bs, csubx, csuby):
    """One batched interpret-mode kernel call over len(bases) frames."""
    n = len(bases)
    return add_grain_batch(
        jnp.asarray(np.stack([y] * n)), jnp.asarray(np.stack([u] * n)),
        jnp.asarray(np.stack([v] * n)),
        jnp.asarray(np.array(bases, np.uint32)),
        jnp.asarray(np.array(bases_up, np.uint32)),
        *table_args(triton_tables(regs)), bs=bs, csubx=csubx, csuby=csuby,
        interpret=True)


@pytest.fixture
def interpret_pipeline(monkeypatch):
    """Let GrainPipeline(engine="triton") run the kernel in interpret mode."""
    monkeypatch.setattr(grain_triton, "require_gpu", lambda: None)
    monkeypatch.setattr(
        grain_triton, "make_batched_step",
        functools.partial(grain_triton.make_batched_step, interpret=True))


@pytest.mark.parametrize("kind", ["sei_ff", "sei_ar", "afgs1"])
@pytest.mark.parametrize("depth,csub", [(10, (2, 2)), (8, (2, 2)),
                                        (10, (2, 1)), (8, (1, 1))])
def test_triton_matches_fast(kind, depth, csub):
    H, W = 144, 256
    R, C = H // 16, W // 16
    csubx, csuby = csub
    bs = depth - 8
    regs = _regs_for(kind, depth, csub)
    hi = (1 << depth) - 1
    rng = np.random.default_rng(7)
    dt = np.uint8 if depth == 8 else np.uint16
    y = rng.integers(0, hi + 1, (R * 16, C * 16)).astype(dt)
    u = rng.integers(0, hi + 1,
                     (R * (16 // csuby), C * (16 // csubx))).astype(dt)
    v = rng.integers(0, hi + 1,
                     (R * (16 // csuby), C * (16 // csubx))).astype(dt)

    # One batched call over all three frames: per-frame lattices and the
    # first-row no-overlap rule hold inside one grid.
    frames = (0, 1, 3)
    bases, bases_up = _bases(regs, frames, R, C)
    tout = _triton(regs, y, u, v, bases, bases_up, bs=bs, csubx=csubx,
                   csuby=csuby)

    ft = fast_tables(regs)
    for fi, f in enumerate(frames):
        fast = add_grain_frame_fast_jit(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
            jnp.uint32(bases[fi]), jnp.uint32(bases_up[fi]), *fast_args(ft),
            height=H, width=W, bs=bs, csubx=csubx, csuby=csuby)
        for p, (r, q) in enumerate(zip(fast, tout)):
            assert np.array_equal(np.asarray(r), np.asarray(q)[fi]), \
                f"{kind} d{depth} csub{csub} frame {f} plane {p}"


def test_pipeline_engine_triton_matches_fast(interpret_pipeline):
    """engine="triton" through GrainPipeline produces identical frames,
    including unaligned dimensions (padding path) and multi-frame state."""
    from versatilefilmgrain_tpu.pipeline import GrainPipeline
    from versatilefilmgrain_tpu.utils import yuv

    Wd, Hd = 250, 140  # unaligned: exercises pad_plane + crop
    rng = np.random.default_rng(11)
    framesets = []
    for _ in range(3):
        yp = rng.integers(0, 1024, (Hd, Wd)).astype(np.uint16)
        up = rng.integers(0, 1024, (Hd // 2, Wd // 2)).astype(np.uint16)
        vp = rng.integers(0, 1024, (Hd // 2, Wd // 2)).astype(np.uint16)
        framesets.append((yp, up, vp))

    pf = GrainPipeline(Wd, Hd, 10, yuv.YUV_420, engine="fast")
    pt = GrainPipeline(Wd, Hd, 10, yuv.YUV_420, engine="triton")
    for n, planes in enumerate(framesets):
        of = pf.process_frame(tuple(p.copy() for p in planes), n)
        ot = pt.process_frame(tuple(p.copy() for p in planes), n)
        for c, (a, b) in enumerate(zip(of, ot)):
            assert np.array_equal(a, b), f"frame {n} plane {c}"


def test_run_file_engine_triton(tmp_path, interpret_pipeline):
    """Batched run_file with the triton engine is bit-identical to fast."""
    from versatilefilmgrain_tpu.pipeline import GrainPipeline
    from versatilefilmgrain_tpu.utils import yuv

    Wd, Hd, nfr = 256, 144, 5
    rng = np.random.default_rng(23)
    src = tmp_path / "in.yuv"
    raw = rng.integers(0, 1024, nfr * Wd * Hd * 3 // 2, dtype=np.uint16)
    raw.tofile(src)

    outs = {}
    for engine in ("fast", "triton"):
        dst = tmp_path / f"out_{engine}.yuv"
        pipe = GrainPipeline(Wd, Hd, 10, yuv.YUV_420, engine=engine)
        n = pipe.run_file(str(src), str(dst), frames=0, batch=2)
        assert n == nfr
        outs[engine] = dst.read_bytes()
    assert outs["fast"] == outs["triton"]


def _random_sei(rng):
    """A random legal FGC SEI: random interval count/bounds (exercises
    pattern counts), FF cutoffs or AR coefficients, random scale shift."""
    from versatilefilmgrain_tpu.models import config as cfgmod

    sei = cfgmod.default_sei()
    sei.model_id = int(rng.integers(0, 2))
    sei.log2_scale_factor = int(rng.integers(2, 8))
    sei.comp_model_present_flag = [1, int(rng.integers(0, 2)),
                                   int(rng.integers(0, 2))]
    for c in range(3):
        n = int(rng.integers(1, 17))
        sei.num_intensity_intervals[c] = n
        bounds = np.sort(rng.choice(256, size=2 * n, replace=False))
        sei.intensity_interval_lower_bound[c, :n] = bounds[0::2]
        sei.intensity_interval_upper_bound[c, :n] = bounds[1::2]
        sei.comp_model_value[c, :, :] = 0
        if sei.model_id == 0:
            sei.num_model_values[c] = 3
            for i in range(n):
                sei.comp_model_value[c, i, :3] = [
                    int(rng.integers(0, 256)), int(rng.integers(2, 15)),
                    int(rng.integers(2, 15))]
        else:
            sei.num_model_values[c] = 6
            for i in range(n):
                sei.comp_model_value[c, i, :6] = [
                    int(rng.integers(0, 200)), int(rng.integers(-20, 21)),
                    int(rng.integers(-10, 11)), int(rng.integers(-20, 21)),
                    int(rng.integers(0, 64)), int(rng.integers(-10, 11))]
    return sei


def test_all_components_absent():
    """comp_model_present = [0,0,0] zero-scales every plane: the kernel
    must reduce to clip(x) on all three planes."""
    from versatilefilmgrain_tpu.models import config as cfgmod
    from versatilefilmgrain_tpu.models import fw
    from versatilefilmgrain_tpu.models.hw import HwRegs

    regs = HwRegs()
    regs.set_depth(10)
    regs.set_chroma_subsampling(2, 2)
    sei = cfgmod.default_sei()
    sei.comp_model_present_flag = [0, 0, 0]
    fw.init_sei(sei, regs)
    assert not regs.slut.any()
    H, W, F = 80, 160, 2
    rng = np.random.default_rng(3)
    planes = (jnp.asarray(rng.integers(0, 1024, (F, H, W), np.uint16)),
              jnp.asarray(rng.integers(0, 1024, (F, H // 2, W // 2),
                                       np.uint16)),
              jnp.asarray(rng.integers(0, 1024, (F, H // 2, W // 2),
                                       np.uint16)))
    cargs = (jnp.zeros(F, jnp.uint32), jnp.zeros(F, jnp.uint32))
    out = add_grain_batch(*planes, *cargs, *table_args(triton_tables(regs)),
                          bs=2, csubx=2, csuby=2, interpret=True)
    lims = [(regs.y_min, regs.y_max), (regs.c_min, regs.c_max),
            (regs.c_min, regs.c_max)]
    for p, (a, (lo, hi)) in enumerate(zip(out, lims)):
        want = np.clip(np.asarray(planes[p], np.int32), lo << 2, hi << 2)
        assert np.array_equal(np.asarray(a, np.int32), want), f"plane {p}"


@pytest.mark.parametrize("seed", range(6))
def test_triton_matches_fast_random_cfg(seed):
    """Differential fuzz: random SEI configs (random interval counts, pattern
    counts, scale shifts, FF and AR modes) through both engines."""
    from versatilefilmgrain_tpu.models import fw
    from versatilefilmgrain_tpu.models.hw import HwRegs

    rng = np.random.default_rng(1000 + seed)
    depth = int(rng.choice([8, 10]))
    csub = [(2, 2), (2, 1), (1, 1)][int(rng.integers(0, 3))]
    H, W = 96, 192
    R, C = H // 16, W // 16
    csubx, csuby = csub
    bs = depth - 8

    regs = HwRegs()
    regs.set_depth(depth)
    regs.set_chroma_subsampling(csubx, csuby)
    try:
        fw.init_sei(_random_sei(rng), regs)
    except ValueError:
        pytest.skip("random config rejected by init (legal-range check)")

    hi = (1 << depth) - 1
    dt = np.uint8 if depth == 8 else np.uint16
    y = rng.integers(0, hi + 1, (R * 16, C * 16)).astype(dt)
    u = rng.integers(0, hi + 1,
                     (R * (16 // csuby), C * (16 // csubx))).astype(dt)
    v = rng.integers(0, hi + 1,
                     (R * (16 // csuby), C * (16 // csubx))).astype(dt)

    frames = (0, 2)
    bases, bases_up = _bases(regs, frames, R, C)
    tout = _triton(regs, y, u, v, bases, bases_up, bs=bs, csubx=csubx,
                   csuby=csuby)
    ft = fast_tables(regs)
    for fi, f in enumerate(frames):
        fast = add_grain_frame_fast_jit(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
            jnp.uint32(bases[fi]), jnp.uint32(bases_up[fi]), *fast_args(ft),
            height=H, width=W, bs=bs, csubx=csubx, csuby=csuby)
        for p, (r, q) in enumerate(zip(fast, tout)):
            assert np.array_equal(np.asarray(r), np.asarray(q)[fi]), \
                f"seed {seed} frame {f} plane {p}"
