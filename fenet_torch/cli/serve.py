"""Serve a deploy checkpoint or artifact over HTTP on every visible card (see
``fenet_torch.serve``; counterpart of ``fenet/cli/serve.py``, plus
``--device``).

    python -m fenet_torch.cli.export_deploy --model .../checkpoints/ \\
        --category 02828884 --dtype bfloat16 --format export
    python -m fenet_torch.cli.serve --deploy_ckpt .../model_deploy.pt2 \\
        --port 8471 --max_batch 32
    curl -s --data-binary @chair.png localhost:8471/predict

SIGTERM drains like Ctrl-C: queued requests resolve, then the listener
closes.
"""

from __future__ import annotations

import argparse
import os
import signal


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--deploy_ckpt", type=str, required=True,
                        help="folded checkpoint from fenet_torch.cli.export_deploy, "
                             "fenet's model_deploy.ckpt, an orbax directory of "
                             "the same tree, or a *.pt2 artifact "
                             "(--format export), recognised by its suffix")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8471)
    parser.add_argument("--max_batch", type=int, default=32,
                        help="fixed device batch (requests are micro-batched and "
                             "padded to it)")
    parser.add_argument("--window_ms", type=float, default=5.0,
                        help="micro-batching window; 0 = dispatch immediately")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: 'cuda' serves over every visible card "
                             "(the batch rounded up to the card count and split), "
                             "'cuda:1' on that card alone, 'cpu' on the host")
    opt = parser.parse_args(argv)

    from fenet_torch.serve.server import make_server
    from fenet_torch.utils.logger import get_logger

    logger = get_logger(os.path.join(os.path.dirname(opt.deploy_ckpt) or ".", "serving.log"))
    server = make_server(opt.deploy_ckpt, host=opt.host, port=opt.port,
                         max_batch=opt.max_batch, window_ms=opt.window_ms,
                         device=opt.device)
    logger.info("serving %s on http://%s:%d (%s)", opt.deploy_ckpt,
                opt.host, server.server_address[1], server.meta)

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down (drain + close)")
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
    return 0


if __name__ == "__main__":
    main()
