"""Tools run on a CUDA card: the kernels' development tools, the parallel
phase's ranks, and fenet's on-chip evidence tools (training equivalence of
the EMD modes, finetune convergence), which also run with ``--device cpu``."""
