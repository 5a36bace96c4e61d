"""Training scripts of the port, run as ``python -m nerfacc_tpu_torch.examples.<name>``."""
