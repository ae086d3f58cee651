"""The DIA SpMM kernel's share of its roofline (``csrc/dia_spmm.cu``,
either branch) over the traced requests: the least time of its launches'
work (``roofline.dia_work``: data, offsets and x read once, y written
once) over their device time in the trace.  Each launch's shapes come
from a probe on the call the DIA operator makes
(``rails_tpu_torch.sparse.formats.dia_spmm``); a replayed launch is
taken at the one shape that was captured.  Nothing to read where the
trace holds no launch, the card has no peaks in the table, or the
launches' shapes are not known."""

from bench_torch import roofline
from bench_torch.probe import Probe

KERNELS = ("dia_direct_kernel", "dia_staged_kernel")


def _work(dia, x, *rest):
    m, n = dia.shape
    nbytes, ops = roofline.dia_work(m, n, dia.offsets, x.shape[1],
                                    x.element_size())
    return nbytes, ops, str(x.dtype).replace("torch.", "")


def probe(cell):
    return Probe("rails_tpu_torch.sparse.formats", "dia_spmm", _work)


def read(ctx):
    launches, seconds = ctx.trace.kernel(KERNELS)
    if launches == 0:
        return None
    works = ctx.probes["dia_spmm_roofline"].works_in("window", launches)
    return roofline.share_pct(works, seconds, ctx.peaks)
