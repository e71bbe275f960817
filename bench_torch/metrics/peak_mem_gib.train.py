"""``torch.cuda.max_memory_allocated`` over the window, in GiB."""


def read(obs):
    peak = obs.get("peak_mem_bytes")
    return None if not peak else peak / 2**30
