"""The LM loop's own share of the device's time: the kernels other than the
BTD solve's and the assembly's (the accept / select `torch.where` copies, the
damped copy, the violations' products) over all kernels' time."""

from benchmark.trace import kernel_time

SOLVER_KERNELS = ("btd_kernel", "btd_small_kernel", "assemble_kernel")


def read(summary: dict, ctx: dict):
    total = sum(k["seconds"] for k in summary["kernels"].values())
    if not total:
        return None
    return 100.0 * (total - sum(kernel_time(summary, k)[1] for k in SOLVER_KERNELS)) / total
