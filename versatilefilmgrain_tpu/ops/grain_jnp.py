"""Plain grain-blending engine: the reference "HW layer" as vectorized JAX.

This is the whole-frame re-formulation of vfgs_hw.c:140-312.  The reference
walks the frame one 16-pixel block at a time through a 2-block pipeline; every
serial dependency it carries is replaced here by a closed form:

* the LFSR schedule (vfgs_hw.c:288-312) becomes a per-(block-row, block-col)
  state lattice computed by GF(2) jump-ahead (see ops/lfsr.py);
* vertical overlap (vfgs_hw.c:199-229) blends *pattern samples of the upper
  block*, whose offsets come from the ``rnd_up`` lattice -- not neighbouring
  pixel data -- so it is a pure per-pixel expression;
* the horizontal deblock pipeline (vfgs_hw.c:243-283) only ever mixes grain
  values within one line, so it becomes a masked 3-tap stencil over the fully
  materialized grain line.

Consequently every output pixel is an independent integer expression of
(input pixel, lattice state, config registers): frames and 16-line tile rows
shard across chips/cores with zero halo exchange, bit-exactly.

All arithmetic is int32 with C-style rounding ``round(a,s) = (a+(1<<(s-1)))>>s``
(vfgs_hw.c:43); arithmetic right-shift on negative int32 matches C/gcc.

Planes must be padded to whole 16x16-luma-block multiples; padded samples
produce garbage grain exactly like the reference's stride region
(vfgs_hw.c:209-211 reads beyond ``width`` into the stride) and are cropped by
the caller.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import lfsr
from .offsets import block_offsets


def _round_shift(a, s):
    """C round(a,s) for positive shift; works for traced s."""
    return (a + (1 << (s - 1))) >> s


def plane_grain(pix, states, states_up, pattern_flat, slut, plut,
                scale_shift, imin, imax, ov_mask=None, *, c: int,
                csubx: int, csuby: int, bs: int):
    """Add grain to one plane.

    pix: (Hp, Wp) int32, padded to (R*bh, C*bw).
    states/states_up: (R, C) uint32 block lattices (current / upper block row).
    pattern_flat: (512*64,) int8 -- this plane class's 8 64x64 patterns.
    slut/plut: (256,) int32 -- scale / pattern LUTs for this component.
    scale_shift/imin/imax: traced int32 scalars (config registers).
    ov_mask: (R,) bool -- which block rows apply vertical overlap (globally
    r >= 1, i.e. picture line y > 15).  Defaults to the single-shard mask;
    sharded callers pass their global slice.
    """
    Hp, Wp = pix.shape
    subx = csubx if c else 1
    suby = csuby if c else 1
    bh, bw = 16 // suby, 16 // subx
    R, C = Hp // bh, Wp // bw
    # Number of vertical-overlap lines per block: luma-lines j==0 and j==1
    # (vfgs_hw.c:175-188); for suby==2 the j==1 line is skipped entirely.
    n_ov = 1 if suby == 2 else 2
    oc1 = np.array([20] if suby == 2 else [12, 24], np.int32).reshape(1, n_ov, 1, 1)
    oc2 = np.array([20] if suby == 2 else [24, 12], np.int32).reshape(1, n_ov, 1, 1)

    s, ox, oy = block_offsets(states, c, csubx, csuby)
    su, oxu, oyu = block_offsets(states_up, c, csubx, csuby)

    in_dtype = pix.dtype
    pix = pix.astype(jnp.int32)
    intensity = (pix >> bs) & 0xFF
    pi = jnp.take(plut, intensity) >> 4     # pattern index (vfgs_hw.c:212)
    sc = jnp.take(slut, intensity)          # scale (vfgs_hw.c:239)

    pi4 = pi.reshape(R, bh, C, bw)
    jj = np.arange(bh, dtype=np.int32)      # oy += j/suby (vfgs_hw.c:197)
    ii = np.arange(bw, dtype=np.int32)
    row = pi4 * 64 + (oy[:, None, :, None] + jj[None, :, None, None])
    col = ox[:, None, :, None] + ii[None, None, None, :]
    P = jnp.take(pattern_flat, row * 64 + col).astype(jnp.int32) \
        * s[:, None, :, None]

    # Vertical overlap (vfgs_hw.c:223-229): oy_up += (16+j)/suby.
    j_up = (16 + jj[:n_ov] * suby) // suby
    row_u = pi4[:, :n_ov] * 64 + (oyu[:, None, :, None]
                                  + j_up[None, :, None, None])
    col_u = oxu[:, None, :, None] + ii[None, None, None, :]
    Pup = jnp.take(pattern_flat, row_u * 64 + col_u).astype(jnp.int32) \
        * su[:, None, :, None]
    blend = _round_shift(P[:, :n_ov] * oc1 + Pup * oc2, 5)
    if ov_mask is None:
        rmask = np.zeros((R, 1, 1, 1), dtype=bool)
        rmask[1:] = True                    # overlap only for y > 15
    else:
        rmask = ov_mask.reshape(R, 1, 1, 1)
    Pov = jnp.where(rmask, blend, P[:, :n_ov])
    P = jnp.concatenate([Pov, P[:, n_ov:]], axis=1).reshape(Hp, Wp)

    # Horizontal deblock (vfgs_hw.c:250-258): both samples adjacent to an
    # interior block boundary become round(prev + 3*self + next, 2).
    Pm = jnp.concatenate([P[:, :1], P[:, :-1]], axis=1)
    Pp = jnp.concatenate([P[:, 1:], P[:, -1:]], axis=1)
    sm = _round_shift(Pm + 3 * P + Pp, 2)
    xs = np.arange(Wp)
    mask = (((xs % bw) == 0) & (xs > 0)) | \
           (((xs % bw) == bw - 1) & (xs < Wp - 1))
    P = jnp.where(mask[None, :], sm, P)

    # Scale, add, clamp (vfgs_hw.c:263-267).
    g = (sc * P + (1 << (scale_shift - 1))) >> scale_shift
    return jnp.clip(pix + g, imin << bs, imax << bs).astype(in_dtype)


def add_grain_frame(y, u, v, base, base_up, pattern, sluts, pluts,
                    scale_shift, y_min, y_max, c_min, c_max, *,
                    height: int, width: int, bs: int, csubx: int, csuby: int):
    """Add grain to one padded YUV frame (jit-traceable).

    y: (R*16, C*16); u, v: (R*(16//csuby), C*(16//csubx)) -- int32 planes,
    padded from the real height x width (R = ceil(height/16), C likewise).
    base / base_up: uint32 scalars -- lattice bases A^(f(R-1)C).S0 and its
    one-block-row-earlier sibling (see ops/lfsr.py; base_up is a dummy for the
    first frame after a (re)seed, where no overlap row exists).
    pattern: (2, 512, 64) int8; sluts/pluts: (3, 256) int32.
    """
    R = -(-height // 16)
    C = -(-width // 16)
    states = lfsr.state_lattice_jax(base, R, C)
    row0u = lfsr.state_lattice_jax(base_up, 1, C)
    states_up = jnp.concatenate([row0u, states[:-1]], axis=0)

    pat = pattern.reshape(2, 512 * 64)
    out = []
    for c, plane in ((0, y), (1, u), (2, v)):
        imin = y_min if c == 0 else c_min
        imax = y_max if c == 0 else c_max
        out.append(plane_grain(
            plane, states, states_up, pat[1 if c else 0],
            sluts[c], pluts[c], scale_shift, imin, imax,
            c=c, csubx=csubx, csuby=csuby, bs=bs))
    return tuple(out)


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "bs", "csubx", "csuby"))
def add_grain_frame_jit(y, u, v, base, base_up, pattern, sluts, pluts,
                        scale_shift, y_min, y_max, c_min, c_max,
                        *, height, width, bs, csubx, csuby):
    return add_grain_frame(
        y, u, v, base, base_up, pattern, sluts, pluts, scale_shift,
        y_min, y_max, c_min, c_max,
        height=height, width=width, bs=bs, csubx=csubx, csuby=csuby)
