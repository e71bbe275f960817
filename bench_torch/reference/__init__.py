"""The plain fp32 reference of the benchmark's cells, in plain PyTorch.

It follows the published models (FiT, arXiv:2402.12376; the SD-VAE
decoder; ADM's diffusion with DDIM and DPM-Solver++(2M)) and imports
nothing of the program: weights come from :mod:`bench_torch.weights` and
the run's seed, inputs from the benchmark's own draws. Matmuls go through
a ``Precision``: fp32 with TF32 off for the reference, or the fp8 control
(:mod:`bench_torch.reference.precision`).
"""
