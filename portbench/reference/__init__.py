"""The plain reference: the A2 cmlp generator (branched, and its deploy
fold), chamfer, the auction EMD, the annealed Sinkhorn loss, batched ICP
and Adam, in plain PyTorch. It imports nothing of the program under test and
works out from the benchmark's own inputs whatever the program derives.

A configuration names the model it is held to by its ``reference`` key:
``reference/<name>.py`` (``generator.py`` for the A2 cmlp generator), which
may import the shared parts of ``generator.py`` (the edge branch, the
decoder, the branches' fold). The harness finds it by that name, in the
benchmark's folder or in a copy of it, and checks at load that it keeps
this contract, which the traffic kinds rely on:

- ``spec(cfg)``: every state_dict entry of the model, in order, as
  (name, shape, kind, fan_in); kinds ``weight``, ``bias`` (drawn from the
  seed and trained), ``bn_weight``, ``bn_bias`` (trained), ``bn_mean``,
  ``bn_var``, ``bn_count``.
- ``parameter_count(cfg)``: the trained parameters, the configuration's
  ``parameters``.
- ``init(cfg, seed, device, head_scale=1.0, random_bn=False)``: the flat
  state on ``device``, every entry of ``spec``, under the program's
  state_dict names, so that it loads into the program with ``strict=True``;
  the decoder's output layers scaled by ``head_scale``; BatchNorm the
  identity, or its affine pair and statistics drawn with ``random_bn``.
- ``forward(p, images, cfg, train, ops)``: (pc1, pc2, pc3) of the branched
  model for (B, H, W, 3) uint8 images, BatchNorm on the batch's statistics
  with ``train``, every product's operands passed through ``ops``.
- ``fold(p, cfg)``: the deploy form of the state.
- ``deploy_forward(q, images, cfg, ops)``: the final cloud of the deploy
  form ``q``.
"""

# Each function of the contract, with the arguments the traffic kinds pass
# it: positional, then by keyword.
CONTRACT = {
    "spec": (("cfg",), ()),
    "parameter_count": (("cfg",), ()),
    "init": (("cfg", "seed", "device"), ("head_scale", "random_bn")),
    "forward": (("p", "images", "cfg", "train", "ops"), ()),
    "fold": (("p", "cfg"), ()),
    "deploy_forward": (("q", "images", "cfg", "ops"), ()),
}
