"""The loss kernels' share of their roofline, in %: the least time of every
call of K2-K6 (``csrc/rasterize.cu``, ``csrc/ae_terms.cu``) in the traced
segment over their kernels' device time."""

from benchmark.counts import bounds


def read(summary):
    return bounds.roofline_share(summary, ("rasterize_cnt_r2", "rasterize_nmap", "ae_terms_fwd",
                                           "ae_terms_bwd", "minr2_from_cnt"))
