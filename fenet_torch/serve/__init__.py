"""Serving for deploy-folded generators on one card (counterpart of
``fenet/serve``): a micro-batcher that pads concurrent requests to one fixed
batch (:mod:`.batcher`), the forward it feeds, from a folded checkpoint or a
frozen ``torch.export`` artifact (:mod:`.server`, :mod:`.artifact`), and a
stdlib HTTP front end (``python -m fenet_torch.cli.serve``).
"""
