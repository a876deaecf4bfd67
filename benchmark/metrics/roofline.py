"""`<kernel>_roofline`: the least time the chip could take for the work a
unit asks of the kernel (the sum over its launches of max(bytes / HBM
bandwidth, operations / bf16 peak), work from the reference's shapes), as a
percentage of the kernel's device time a unit in the trace. "gelu" is
gelu_bf16 and gelu_bf16_grad together. Nothing when the kernel did not run
or the configuration asks no work of it."""

from benchmark.harness.peaks import bound_s

KERNELS = {"gelu": ("gelu_bf16", "gelu_bf16_grad")}


def read(r, name):
    kernel = name.split(".")[0][: -len("_roofline")]
    names = KERNELS.get(kernel, (kernel,))
    table = r.trace.by_category()
    seconds = sum(table.get("own:" + k, 0.0) for k in names)
    work = r.work.get(kernel)
    if not seconds or not work:
        return None
    least = sum(n * bound_s(nbytes, ops) for n, nbytes, ops in work)
    return 100.0 * least * r.units / seconds
