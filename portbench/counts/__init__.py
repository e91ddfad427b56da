"""Operations and bytes from shapes and fixed iteration counts alone: what
the MFU and roofline figures divide by a measured time. Nothing here reads
a counter of the program.

A configuration's model is counted by ``counts/<name>.py``, the name of its
``reference`` key (``generator.py`` for the A2 cmlp generator). The harness
finds it by that name, in the benchmark's folder or in a copy of it, and
checks at load that it keeps this contract, which the MFU readers rely on:
``forward_flops(cfg)``, ``train_flops(cfg)`` and ``deploy_flops(cfg)``,
the floating-point operations a sample of the branched model's forward, of
its forward and backward, and of the deploy form's forward. A kernel's own
count (``sinkhorn.py``) is imported by the reader of its roofline.
"""

# Each function of the contract, with the arguments the readers pass it:
# positional, then by keyword.
CONTRACT = {
    "forward_flops": (("cfg",), ()),
    "train_flops": (("cfg",), ()),
    "deploy_flops": (("cfg",), ()),
}
