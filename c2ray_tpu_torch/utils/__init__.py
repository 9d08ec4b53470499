"""Host utilities of the port: Fortran I/O, outputs, checkpoints, clocks."""
