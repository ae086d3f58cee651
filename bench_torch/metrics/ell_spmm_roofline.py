"""The ELL SpMM kernel's share of its roofline (``csrc/ell_spmm.cu``)
over the traced requests: the least time of its launches' work
(``roofline.ell_work``: indices, values and x read once, y written once)
over their device time in the trace.  Each launch's shapes come from a
probe on the call the ELL operator makes
(``rails_tpu_torch.sparse.formats.ell_spmm``), in the Schur reduction's
A12, A21 and A22 applies; a replayed launch is taken at the one shape
that was captured.  Nothing to read where the trace holds no launch, the
card has no peaks in the table, or the launches' shapes are not
known."""

from bench_torch import roofline
from bench_torch.probe import Probe

KERNELS = ("ell_spmm_kernel",)


def _work(ell, x, *rest):
    m, n = ell.shape
    nbytes, ops = roofline.ell_work(m, n, ell.indices.shape[1], x.shape[1],
                                    x.element_size())
    return nbytes, ops, str(x.dtype).replace("torch.", "")


def probe(cell):
    return Probe("rails_tpu_torch.sparse.formats", "ell_spmm", _work)


def read(ctx):
    launches, seconds = ctx.trace.kernel(KERNELS)
    if launches == 0:
        return None
    works = ctx.probes["ell_spmm_roofline"].works_in("window", launches)
    return roofline.share_pct(works, seconds, ctx.peaks)
