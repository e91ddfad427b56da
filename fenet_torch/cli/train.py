"""Training CLI on PyTorch (counterpart of ``fenet/cli/train.py``): the same
flags, plus ``--device``.

    python -m fenet_torch.cli.train --cats 02828884 --nepoch 10 \\
        --dir_path out/ --splits_path data/splits \\
        --data_dir_imgs data/ShapeNetRendering/ \\
        --data_dir_pcl data/ShapeNet_pointclouds/
"""

from __future__ import annotations

import argparse
import time

from fenet_torch.cli.common import DEFAULT_TRAIN_CATS, add_common_args, config_from_args
from fenet_torch.train.driver import train_net


def main(argv=None):
    parser = add_common_args(argparse.ArgumentParser())
    parser.add_argument("--cats", nargs="*", default=None,
                        help="category ids to train (default: the reference's)")
    opt = parser.parse_args(argv)
    print(opt)

    cats = opt.cats or ([opt.category] if opt.category else DEFAULT_TRAIN_CATS)
    start = time.time()
    results = {}
    for cat in cats:
        cfg = config_from_args(opt)
        cfg.category = cat
        t0 = time.time()
        results[cat] = train_net(cat, cfg, device=opt.device)
        print("cat: %s  this category train time: %f h" % (cat, (time.time() - t0) / 3600))
    print("all categories run time :%f h" % ((time.time() - start) / 3600))
    return results


if __name__ == "__main__":
    main()
