"""The plain versions of the port's kernels, under the names the layers
call: each name takes its kernel wrapper's arguments and runs the plain
version on whatever device its tensors are on."""
from .join_kmap import join_kmap_plain
from .occupancy_conv import (c1z_unpack_bits, occupancy_conv_dw_plain,
                             occupancy_conv_fwd_plain)
from .radius_topk import windowed_cell_topk_plain
from .scalar_conv import (scalar_conv_dw_plain, scalar_conv_dx_plain,
                          scalar_conv_fwd_plain)
from .sparse_conv import (compacted_rows, sparse_conv_dw_plain,
                          sparse_conv_implicit_bwd_plain,
                          sparse_conv_implicit_fwd_plain,
                          sparse_conv_table_fwd_plain)


def join_kmap(key_hi, key_lo, perm, qhi, qlo, *, chunk=None):
    return join_kmap_plain(key_hi, key_lo, perm, qhi, qlo)


def occupancy_conv_fwd(aux, skeys, w, out_dtype=None, *, chunk=None):
    return occupancy_conv_fwd_plain(aux, skeys, w, out_dtype or w.dtype)


def occupancy_conv_dw(sbits, g, kcube):
    return occupancy_conv_dw_plain(sbits, g, kcube)


def scalar_conv_fwd(x, w, aux, skeys, srow, row_sel=None, *, chunk=None):
    return scalar_conv_fwd_plain(x, w, aux, skeys, srow, row_sel)


def scalar_conv_dw(x, g, aux, skeys, srow, kcube, row_sel=None, *,
                   chunk=None):
    return scalar_conv_dw_plain(x, g, aux, skeys, srow, kcube, row_sel)


def scalar_conv_dx(g, w, aux, skeys, srow, row_sel=None):
    return scalar_conv_dx_plain(g, w, aux, skeys, srow, row_sel)


def windowed_cell_topk(tkey_s, trow_s, txyz_s, pbase, qxyz, r2, kn):
    return windowed_cell_topk_plain(tkey_s, trow_s, txyz_s, pbase, qxyz, r2,
                                    kn)


def sparse_conv_implicit_fwd(x, w, qkey, skeys, srow):
    return sparse_conv_implicit_fwd_plain(x, w, qkey, skeys, srow)


def sparse_conv_implicit_bwd(x, g, w, rqkey, skeys, srow, want_dx=True):
    return sparse_conv_implicit_bwd_plain(x, g, w, rqkey, skeys, srow,
                                          want_dx)


def sparse_conv_table_fwd(x, w, idx):
    return sparse_conv_table_fwd_plain(x, w, idx)


def sparse_conv_dw(x, g, qkey, skeys=None, srow=None):
    return sparse_conv_dw_plain(x, g, qkey, skeys, srow)


__all__ = ["c1z_unpack_bits", "compacted_rows", "join_kmap",
           "occupancy_conv_dw", "occupancy_conv_fwd", "scalar_conv_dw",
           "scalar_conv_dx", "scalar_conv_fwd", "sparse_conv_dw",
           "sparse_conv_implicit_bwd", "sparse_conv_implicit_fwd",
           "sparse_conv_table_fwd", "windowed_cell_topk"]
