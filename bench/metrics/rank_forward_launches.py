"""rank_forward_launches: the host runtime calls that put work on the card
(kernel launches, asynchronous copies and fills) that start inside a
``dlrm.forward`` span, over the number of those spans: the launches of one
batch's dispatch, counted where they happen. A fused kernel or a CUDA
graph lowers it."""
import bisect

from bench.harness.spans import spans

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync", "cudaMemsetAsync")


def is_launch(name: str) -> bool:
    return name in LAUNCHES or name.startswith("cuLaunchKernel")


def read(run):
    forward = spans(run)
    if not forward:
        return None
    starts = [a for a, _ in forward]
    n = 0
    for name, a, _ in run.trace.host:
        if is_launch(name):
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < forward[i][1]:
                n += 1
    return n / len(forward)
