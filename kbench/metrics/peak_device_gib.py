"""The CUDA caching allocator's peak of allocated bytes over the window
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats` at its
start), in GiB, as the harness reads it from the allocator."""

SOURCE = "device_trace"


def read(obs):
    return obs.peak_bytes / 2 ** 30
