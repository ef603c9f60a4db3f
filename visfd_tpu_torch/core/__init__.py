"""The device-side array model (``grid.VoxelGrid``)."""
