"""The plain reference the benchmark holds the program to: a PDHG solve
in plain PyTorch (``pdhg``), and the judge that decides ``correct``
from the benchmark's own instances (``judge``).  It imports nothing of
the program (``repro_torch``) and nothing of the JAX package."""
