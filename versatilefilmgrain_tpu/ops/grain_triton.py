"""Fused one-pass grain kernel for NVIDIA GPUs (Pallas, Triton route).

Bit-exact with ops/grain_jnp.py.  One program owns one 16-luma-line block
row of one frame over ``NB`` block columns, and the matching chroma block
rows, so every input sample is read once and every output sample written
once:

* the LFSR state lattice and the per-block offsets stay in XLA around the
  call; they collapse to one int32 word per (component, frame, block row,
  block column) -- pattern base address, sign, the upper block's base
  address and sign, and whether the block row blends vertically;
* the (scale, pattern index) LUT pair is one 768-entry packed table and the
  whole pattern store of a plane class is 8 x 64 x 64 int8 = 32 KB, so both
  are per-pixel gathers that stay in L1;
* vertical overlap (vfgs_hw.c:199-229) recomputes the upper block's pattern
  samples from its word: no carry between programs, which run in any order;
* the horizontal deblock (vfgs_hw.c:250-258) needs grain one column left
  and right of each block edge; those columns are recomputed from the
  neighbouring pixels and block words, four per block, so the tile never
  has to be shifted in registers;
* scale, add and clip happen in registers before one masked store.

Every step is integer arithmetic, so nothing depends on the GPU's float
modes.  ``interpret=True`` runs the same kernel on the CPU for tests.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from . import lfsr
from .offsets import block_offsets
from ..utils.parsers import ConfigError

# Block columns per program (a power of two) and warps per program.  On an
# H100 80GB HBM3 at a 400 W power limit, 4K 10-bit 4:2:0, batch 8: NB=16
# with 8 warps 0.546 ms/step, with 4 warps 0.637; NB=8 (4 warps) 0.713;
# NB=32 (8 warps) 0.542.
NB = 16
NUM_WARPS = 8


def require_gpu() -> None:
    """The kernel is compiled by Triton, which only targets GPUs."""
    if jax.default_backend() != "gpu":
        raise ConfigError(
            f"the triton engine needs a GPU backend, found "
            f"{jax.default_backend()!r}; use engine='fast' or 'auto'")


def triton_tables(regs) -> dict:
    """Config-dependent kernel operands from the register file.

    ``lut`` packs slut | pattern index << 16 per (component, intensity);
    the pattern index is < 8 for every register file fw.py builds
    (MAX_PATTERNS), and ``& 7`` keeps the gather in bounds regardless."""
    lut = (regs.slut.astype(np.int32)
           | (((regs.plut.astype(np.int32) >> 4) & 7) << 16))
    prm = np.zeros(8, np.int32)
    prm[:5] = (regs.scale_shift, regs.y_min << regs.bs, regs.y_max << regs.bs,
               regs.c_min << regs.bs, regs.c_max << regs.bs)
    # Copies, not views: the register file is rewritten at the next config
    # switch while a batch that read these tables may still be in flight.
    return dict(lut=lut.reshape(-1),
                pat_luma=regs.pattern[0].reshape(-1).copy(),
                pat_chroma=regs.pattern[1].reshape(-1).copy(),
                prm=prm)


TABLE_KEYS = ("lut", "pat_luma", "pat_chroma", "prm")


def table_args(tables: dict):
    return tuple(jnp.asarray(tables[k]) for k in TABLE_KEYS)


def block_words(states, states_up, blend, *, c: int, csubx: int, csuby: int):
    """Pack one block's offsets into an int32 word (see the module doc).

    states/states_up: (..., R, C) uint32 lattices; blend: (..., R, 1) bool,
    True where the block row applies vertical overlap."""
    suby = csuby if c else 1
    s, ox, oy = block_offsets(states, c, csubx, csuby)
    su, oxu, oyu = block_offsets(states_up, c, csubx, csuby)
    addr = oy * 64 + ox
    addr_up = (oyu + 16 // suby) * 64 + oxu
    return (addr | ((s < 0).astype(jnp.int32) << 12) | (addr_up << 13)
            | ((su < 0).astype(jnp.int32) << 25)
            | (blend.astype(jnp.int32) << 26))


def _plane_tile(pix_ref, out_ref, w_ref, lut_ref, pat_ref, ss, lo, hi, *,
                f, r, t, c, F, R, C, bh, bw, suby, bs):
    """Grain one (bh, NB*bw) tile of one plane."""
    n_ov = 1 if suby == 2 else 2
    Wp = C * bw
    j = jnp.arange(bh, dtype=jnp.int32)[:, None, None]
    nb = jnp.arange(NB, dtype=jnp.int32)[None, :, None]
    ii = jnp.arange(bw, dtype=jnp.int32)[None, None, :]
    blk = t * NB + nb                            # global block column
    row0 = (f * R + r) * bh                      # first line of the tile
    wrow = ((c * F + f) * R + r) * C             # word index of column 0
    if suby == 2:
        oc1 = oc2 = 20
    else:
        oc1 = jnp.where(j == 0, 12, 24)
        oc2 = jnp.where(j == 0, 24, 12)

    def grain(bq, iq):
        """Pre-deblock grain, intensity entry and pixels at block column
        ``bq``, in-block column ``iq`` (broadcast against the rows)."""
        xq = jnp.clip(bq * bw + iq, 0, Wp - 1)
        p = plt.load(pix_ref.at[(row0 + j) * Wp + xq]).astype(jnp.int32)
        e = plt.load(lut_ref.at[c * 256 + ((p >> bs) & 0xFF)])
        w = plt.load(w_ref.at[wrow + jnp.clip(bq, 0, C - 1)])
        base = (e >> 16) * 4096 + j * 64 + iq
        g = plt.load(pat_ref.at[base + (w & 0xFFF)]).astype(jnp.int32)
        g = jnp.where(((w >> 12) & 1) == 1, -g, g)
        ov = (j < n_ov) & (((w >> 26) & 1) == 1)
        up_idx = jnp.where(ov, base + ((w >> 13) & 0xFFF), 0)
        gu = plt.load(pat_ref.at[up_idx], mask=ov,
                      other=0).astype(jnp.int32)
        gu = jnp.where(((w >> 25) & 1) == 1, -gu, gu)
        g = jnp.where(ov, (g * oc1 + gu * oc2 + 16) >> 5, g)
        return g, e, p

    g, e, p = grain(blk, ii)
    # Deblock (vfgs_hw.c:250-258): both samples beside an interior block
    # edge become round(left + 3*self + right, 2).  Neighbour sums for the
    # first and last column of each block, shape (bh, NB, 1).
    nb_first = grain(blk - 1, bw - 1)[0] + grain(blk, 1)[0]
    nb_last = grain(blk, bw - 2)[0] + grain(blk + 1, 0)[0]
    x = blk * bw + ii
    g = jnp.where((ii == 0) & (x > 0), (nb_first + 3 * g + 2) >> 2,
                  jnp.where((ii == bw - 1) & (x < Wp - 1),
                            (nb_last + 3 * g + 2) >> 2, g))
    out = jnp.clip(p + (((e & 0xFFFF) * g + (1 << (ss - 1))) >> ss), lo, hi)
    plt.store(out_ref.at[(row0 + j) * Wp + x], out.astype(out_ref.dtype),
              mask=jnp.broadcast_to(x < Wp, out.shape))


def _kernel(y_ref, u_ref, v_ref, w_ref, lut_ref, patl_ref, patc_ref,
            prm_ref, yo_ref, uo_ref, vo_ref, *, F, R, C, bs, csubx, csuby):
    f, r, t = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    ss = prm_ref[0]
    common = dict(f=f, r=r, t=t, F=F, R=R, C=C, bs=bs)
    _plane_tile(y_ref, yo_ref, w_ref, lut_ref, patl_ref, ss, prm_ref[1],
                prm_ref[2], c=0, bh=16, bw=16, suby=1, **common)
    for c, (src, dst) in ((1, (u_ref, uo_ref)), (2, (v_ref, vo_ref))):
        _plane_tile(src, dst, w_ref, lut_ref, patc_ref, ss, prm_ref[3],
                    prm_ref[4], c=c, bh=16 // csuby, bw=16 // csubx,
                    suby=csuby, **common)


def grain_planes(y, u, v, states, states_up, blend, lut, pat_luma,
                 pat_chroma, prm, *, bs: int, csubx: int, csuby: int,
                 interpret: bool = False):
    """Grain a batch of padded planes with the fused kernel.

    y: (F, R*16, C*16); u, v: (F, R*16/csuby, C*16/csubx) uint8/uint16.
    states/states_up: (F, R, C) uint32 block lattices (current / upper block
    row); blend: (R,) bool, which block rows apply vertical overlap.
    """
    F, Hp, Wp = y.shape
    R, C = Hp // 16, Wp // 16
    blend = jnp.broadcast_to(jnp.asarray(blend).reshape(1, R, 1), (F, R, 1))
    words = jnp.stack([block_words(states, states_up, blend, c=c,
                                   csubx=csubx, csuby=csuby)
                       for c in range(3)]).reshape(-1)
    kernel = functools.partial(_kernel, F=F, R=R, C=C, bs=bs, csubx=csubx,
                               csuby=csuby)
    planes = (y, u, v)
    outs = pl.pallas_call(
        kernel,
        out_shape=tuple(jax.ShapeDtypeStruct((p.size,), p.dtype)
                        for p in planes),
        grid=(F, R, pl.cdiv(C, NB)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="vfg_grain",
    )(*(p.reshape(-1) for p in planes), words, lut, pat_luma, pat_chroma,
      prm)
    return tuple(o.reshape(p.shape) for o, p in zip(outs, planes))


def add_grain_batch(y, u, v, bases, bases_up, lut, pat_luma, pat_chroma,
                    prm, *, bs: int, csubx: int, csuby: int,
                    interpret: bool = False):
    """Whole-frame grain for a batch: (F,) lattice bases as in
    ops.grain_jnp.add_grain_frame, one base per frame."""
    F, Hp, Wp = y.shape
    R, C = Hp // 16, Wp // 16
    states = jax.vmap(lambda b: lfsr.state_lattice_jax(b, R, C))(bases)
    row0 = jax.vmap(lambda b: lfsr.state_lattice_jax(b, 1, C))(bases_up)
    states_up = jnp.concatenate([row0, states[:, :-1]], axis=1)
    blend = np.arange(R) >= 1               # overlap only for y > 15
    return grain_planes(y, u, v, states, states_up, blend, lut, pat_luma,
                        pat_chroma, prm, bs=bs, csubx=csubx, csuby=csuby,
                        interpret=interpret)


def make_batched_step(*, bs: int, csubx: int, csuby: int,
                      interpret: bool = False):
    """Jitted ``step(y, u, v, bases, bases_up, *table_args(tables))``.

    Config tables are arguments, so one compiled step serves every config
    of a geometry."""
    if not interpret:
        require_gpu()
    return jax.jit(functools.partial(add_grain_batch, bs=bs, csubx=csubx,
                                     csuby=csuby, interpret=interpret))
