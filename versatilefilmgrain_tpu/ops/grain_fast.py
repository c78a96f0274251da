"""Gather-free XLA formulation of the grain engine (bit-exact).

The engine off the GPU (``engine="fast"``).  It removes every per-pixel
gather of the plain engine (ops/grain_jnp.py) using two structural facts of
the algorithm:

1. **Pattern fetches have tiny offset entropy.**  Block offsets are quantized
   to 12 vertical x 13 horizontal positions (vfgs_hw.c:99-138), so each
   pattern has only 156 possible (16+overlap)-row windows.  We pre-extract all
   windows into a (156, 8, rows, bw) table at config time and fetch one
   2KB window per *block* with a coarse `take` (runs at HBM speed), then
   select among the <=8 patterns per *pixel* with a 3-bit mux (7 selects).

2. **The intensity LUTs are short run-length codes.**  sLUT/pLUT are built
   from <=256 intensity intervals (vfgs_fw.c:597-639) and are piecewise
   constant; we decompose the packed (scale, pattern-index) pair into its
   runs and evaluate `sum_s (intensity >= start_s) * delta_s` -- a fused
   compare/add chain instead of a 256-entry gather.

Both transforms are exact: identical integers come out.  Bit-exactness versus
the reference engine is covered by tests/test_fast_engine.py and the golden
CLI suite.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import lfsr
from .offsets import block_offsets
from .grain_jnp import _round_shift

_PACK_SHIFT = 9  # scale in bits 0..8, pattern index in bits 9..12


def build_window_table(pattern_class: np.ndarray, bh: int, bw: int,
                       n_ov: int, ymul: int, xmul: int):
    """All possible offset windows per pattern, split into two tables:

    * ``cur`` (156, 8, bh, bw): rows serving the block itself (pattern rows
      oy+j, vfgs_hw.c:218);
    * ``up`` (156, 8, n_ov, bw): rows serving the *next* block row's vertical
      overlap (pattern rows oy+16/suby+j, vfgs_hw.c:206,225).

    Splitting keeps the per-block overlap fetch to the n_ov rows actually
    consumed instead of a full window.
    """
    rows = bh + n_ov
    win = np.zeros((12 * 13, 8, rows, bw), dtype=np.int8)
    for a in range(12):
        oy = a * ymul
        for b in range(13):
            ox = b * xmul
            win[a * 13 + b] = pattern_class[:, oy:oy + rows, ox:ox + bw]
    return np.ascontiguousarray(win[:, :, :bh]), \
        np.ascontiguousarray(win[:, :, bh:])


def _gather_windows(win, widx):
    """Fetch per-block windows directly in block-row-major layout.

    win: (156, 8, rows, bw); widx: (R, C) int32.
    Returns (R, 8, rows, C, bw) -- the gather's dimension numbers place the
    (R, C) batch dims around the window dims, so no materialized transpose
    is needed downstream.
    """
    import jax

    _, p8, rows, bw = win.shape
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2, 4), collapsed_slice_dims=(0,),
        start_index_map=(0,))
    return jax.lax.gather(
        win, widx[..., None].astype(jnp.int32), dnums, (1, p8, rows, bw),
        mode=jax.lax.GatherScatterMode.CLIP)


def build_segments(slut: np.ndarray, plut: np.ndarray):
    """Run-length decomposition of the packed (scale, pattern-index) LUT.

    Returns (starts, deltas) int32 arrays of equal length (padded with
    zero-deltas) such that for any intensity i:
        acc = sum_k (i >= starts[k]) * deltas[k]
        slut[i] == acc & 511;  (plut[i] >> 4) == acc >> 9
    """
    pairs = slut.astype(np.int32) | ((plut.astype(np.int32) >> 4) << _PACK_SHIFT)
    starts, deltas = [], []
    prev = 0
    for i in range(256):
        if pairs[i] != prev:
            starts.append(i)
            deltas.append(int(pairs[i]) - prev)
            prev = int(pairs[i])
    if not starts:
        starts, deltas = [0], [0]
    return np.array(starts, np.int32), np.array(deltas, np.int32)


def fast_tables(regs) -> dict:
    """Host-side packaging of the register file for the fast engine."""
    csubx, csuby = regs.csubx, regs.csuby
    win_l, win_l_up = build_window_table(regs.pattern[0], 16, 16, 2, 4, 4)
    bh_c, bw_c = 16 // csuby, 16 // csubx
    n_ov_c = 1 if csuby == 2 else 2
    win_c, win_c_up = build_window_table(regs.pattern[1], bh_c, bw_c, n_ov_c,
                                         4 // csuby, 4 // csubx)
    seg = [build_segments(regs.slut[c], regs.plut[c]) for c in range(3)]
    S = max(len(s) for s, _ in seg)
    S = -(-S // 8) * 8  # pad to a multiple of 8 to bucket recompiles
    starts = np.zeros((3, S), np.int32)
    deltas = np.zeros((3, S), np.int32)
    for c, (s, d) in enumerate(seg):
        starts[c, :len(s)] = s
        deltas[c, :len(d)] = d
    return dict(
        win_luma=win_l, win_luma_up=win_l_up,
        win_chroma=win_c, win_chroma_up=win_c_up,
        seg_starts=starts, seg_deltas=deltas,
        scale_shift=np.int32(regs.scale_shift),
        y_min=np.int32(regs.y_min), y_max=np.int32(regs.y_max),
        c_min=np.int32(regs.c_min), c_max=np.int32(regs.c_max),
    )


def _mux8(strip, pi):
    """Per-pixel select among 8 pattern planes.

    strip: (R, 8, rows, C, bw); pi: (R, rows, C, bw).  3-bit binary mux.
    """
    b0 = (pi & 1) == 1
    b1 = (pi & 2) == 2
    b2 = (pi & 4) == 4
    a = jnp.where(b0, strip[:, 1], strip[:, 0])
    b = jnp.where(b0, strip[:, 3], strip[:, 2])
    c = jnp.where(b0, strip[:, 5], strip[:, 4])
    d = jnp.where(b0, strip[:, 7], strip[:, 6])
    e = jnp.where(b1, b, a)
    f = jnp.where(b1, d, c)
    return jnp.where(b2, f, e)


def plane_grain_fast(pix, states, states_up, win_cur, win_up, seg_starts,
                     seg_deltas, scale_shift, imin, imax, ov_mask=None, *,
                     c: int, csubx: int, csuby: int, bs: int):
    """Bit-exact fast-path version of ops.grain_jnp.plane_grain."""
    Hp, Wp = pix.shape
    subx = csubx if c else 1
    suby = csuby if c else 1
    bh, bw = 16 // suby, 16 // subx
    R, C = Hp // bh, Wp // bw
    n_ov = 1 if suby == 2 else 2
    ymul, xmul = 4 // suby, 4 // subx
    oc1 = np.array([20] if suby == 2 else [12, 24], np.int32).reshape(1, n_ov, 1, 1)
    oc2 = np.array([20] if suby == 2 else [24, 12], np.int32).reshape(1, n_ov, 1, 1)

    s, ox, oy = block_offsets(states, c, csubx, csuby)
    su, oxu, oyu = block_offsets(states_up, c, csubx, csuby)
    widx = (oy // ymul) * 13 + ox // xmul          # (R, C)
    widx_up = (oyu // ymul) * 13 + oxu // xmul

    in_dtype = pix.dtype
    pix = pix.astype(jnp.int32)
    intensity = (pix >> bs) & 0xFF

    # LUT pair via run-length decomposition (fused compare/add chain).
    S = seg_starts.shape[0]
    acc = jnp.zeros_like(intensity)
    for k in range(S):
        acc = acc + jnp.where(intensity >= seg_starts[k], seg_deltas[k], 0)
    sc = acc & ((1 << _PACK_SHIFT) - 1)
    pi4 = (acc >> _PACK_SHIFT).reshape(R, bh, C, bw)

    # Window fetch in block-row-major layout; no transpose materialized.
    wc = _gather_windows(win_cur, widx)            # (R, 8, bh, C, bw)
    wu = _gather_windows(win_up, widx_up)          # (R, 8, n_ov, C, bw)

    P = _mux8(wc, pi4).astype(jnp.int32) * s[:, None, :, None]
    Pup = _mux8(wu, pi4[:, :n_ov]).astype(jnp.int32) \
        * su[:, None, :, None]

    blend = _round_shift(P[:, :n_ov] * oc1 + Pup * oc2, 5)
    if ov_mask is None:
        rmask = np.zeros((R, 1, 1, 1), dtype=bool)
        rmask[1:] = True
    else:
        rmask = ov_mask.reshape(R, 1, 1, 1)
    Pov = jnp.where(rmask, blend, P[:, :n_ov])
    P = jnp.concatenate([Pov, P[:, n_ov:]], axis=1).reshape(Hp, Wp)

    # Horizontal deblock (vfgs_hw.c:250-258).
    Pm = jnp.concatenate([P[:, :1], P[:, :-1]], axis=1)
    Pp = jnp.concatenate([P[:, 1:], P[:, -1:]], axis=1)
    sm = _round_shift(Pm + 3 * P + Pp, 2)
    xs = np.arange(Wp)
    mask = (((xs % bw) == 0) & (xs > 0)) | \
           (((xs % bw) == bw - 1) & (xs < Wp - 1))
    P = jnp.where(mask[None, :], sm, P)

    g = (sc * P + (1 << (scale_shift - 1))) >> scale_shift
    return jnp.clip(pix + g, imin << bs, imax << bs).astype(in_dtype)


def add_grain_frame_fast(y, u, v, base, base_up, win_luma, win_luma_up,
                         win_chroma, win_chroma_up, seg_starts, seg_deltas,
                         scale_shift, y_min, y_max, c_min, c_max, *,
                         height: int, width: int, bs: int, csubx: int,
                         csuby: int):
    """Fast-path whole-frame grain (same lattice semantics as add_grain_frame)."""
    R = -(-height // 16)
    C = -(-width // 16)
    states = lfsr.state_lattice_jax(base, R, C)
    row0u = lfsr.state_lattice_jax(base_up, 1, C)
    states_up = jnp.concatenate([row0u, states[:-1]], axis=0)

    out = []
    for c, plane in ((0, y), (1, u), (2, v)):
        imin = y_min if c == 0 else c_min
        imax = y_max if c == 0 else c_max
        out.append(plane_grain_fast(
            plane, states, states_up,
            win_luma if c == 0 else win_chroma,
            win_luma_up if c == 0 else win_chroma_up,
            seg_starts[c], seg_deltas[c], scale_shift, imin, imax,
            c=c, csubx=csubx, csuby=csuby, bs=bs))
    return tuple(out)


FAST_TABLE_KEYS = ("win_luma", "win_luma_up", "win_chroma", "win_chroma_up",
                   "seg_starts", "seg_deltas")
FAST_SCALAR_KEYS = ("scale_shift", "y_min", "y_max", "c_min", "c_max")


def fast_args(ft: dict):
    """Flatten a fast_tables() dict into positional engine args."""
    return tuple(jnp.asarray(ft[k]) for k in FAST_TABLE_KEYS) \
        + tuple(ft[k] for k in FAST_SCALAR_KEYS)


@functools.partial(
    jax.jit, static_argnames=("height", "width", "bs", "csubx", "csuby"))
def add_grain_frame_fast_jit(y, u, v, base, base_up, win_luma, win_luma_up,
                             win_chroma, win_chroma_up, seg_starts,
                             seg_deltas, scale_shift, y_min, y_max, c_min,
                             c_max, *, height, width, bs, csubx, csuby):
    return add_grain_frame_fast(
        y, u, v, base, base_up, win_luma, win_luma_up, win_chroma,
        win_chroma_up, seg_starts, seg_deltas, scale_shift, y_min, y_max,
        c_min, c_max,
        height=height, width=width, bs=bs, csubx=csubx, csuby=csuby)
