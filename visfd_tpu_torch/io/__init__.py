from visfd_tpu_torch.io.mrc import MrcHeader, MrcImage, read_mrc, write_mrc  # noqa: F401
