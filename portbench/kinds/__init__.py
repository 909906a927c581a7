"""How a call reaches the program, one file a kind, found by the name a
traffic mix gives under ``"kind"``: each holds a ``Traffic`` class (see
``portbench/generator.py``) and a ``control(fmt)``, a context manager
that plants the control of ``correct`` in the program (fmt: the
configuration's format module)."""
