"""``SamplingServer.stats()`` occupancy (real slots over dispatched slots
of the batches finished) at the window's close, in percent."""


def read(obs):
    occ = obs.get("occupancy")
    return None if occ is None else 100.0 * occ
