"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy: frozen copies of the port's plain frame
mathematics (threefry PRNG, nuclear data tables, decay engine, pair force
and integration, overlap projection, shell initialiser, rasterizer), with
the frame loops written out in :mod:`.frame`. Nothing here imports the
program, so a later change to the program cannot move the yardstick.
"""
