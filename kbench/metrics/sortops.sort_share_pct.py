"""The share of the device's busy time in the traced window spent in
`torch.sort`'s kernels (CUB's radix sort, PyTorch's small-sort
kernels), in percent."""

SOURCE = "device_trace"
LAYER = "ops.sortops"
MOVES = "build_kmers_per_s"
PATTERN = r"RadixSort|radixSort|sortKeyValueInplace|bitonicSortKV"


def read(obs):
    if obs.trace is None:
        return None
    busy = obs.trace.busy_us()
    if busy <= 0:
        return None
    return 100.0 * obs.trace.kernel_us(PATTERN) / busy
