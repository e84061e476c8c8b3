"""Frozen copies the benchmark measures with: instance generators, the
H100's peaks and the bound arithmetic, and the bytes one PDHG step
needs.  Later changes to the program do not move them."""
