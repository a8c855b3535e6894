"""FLOP and bytes of one call of an op, from its input shapes, one file per op.

Each module ``costs/<op>.py`` has ``OP``, the op's name in a trace, and
``cost(shapes) -> (flop, bytes)``, ``shapes`` the call's input shapes in the
op's argument order. Complex products count 8 FLOP a multiply-add (the
4-multiplication form); each input is read once and each output written
once, whatever the kernels read again (copied from the port's
``chip_smoke.py``).
"""
