"""Host-side antibody numbering: AHo alignment + IMGT grid placement.

Copies of the JAX package's numbering modules (consensus, align, imgt, aho,
germline, regions); the port imports nothing from hudiff_tpu.
"""
