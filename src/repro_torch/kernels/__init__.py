"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the device dispatch between them (:mod:`repro_torch.kernels.ops`)."""
