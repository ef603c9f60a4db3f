"""The benchmark's own machinery: the manifest, the MRC files it
writes and reads, the stage clock, the host-memory sampler, the device
trace and the closed loop that drives ``filter_mrc``.  Nothing here
imports ``visfd_tpu_torch`` except ``cell``, which runs it."""
