"""The host's share of a batch, by the benchmark's clock: seconds until
``FiTSampler`` returns (all of the batch enqueued) over seconds until its
latents are read back, summed over the window's batches, in percent."""


def read(obs):
    if not obs.get("batch_s"):
        return None
    return 100.0 * obs["enqueue_s"] / obs["batch_s"]
