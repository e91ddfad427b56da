"""fenet_torch's image transforms against fenet's, on uint8 and float32 HWC
inputs, with identically seeded RandomStates: every output must equal
fenet's byte for byte, dtype included (tolerance: exact), over several
calls (so that the draws from the state line up too); and a
ShapeNetDataset(transform=...) sample against fenet's.
"""

import numpy as np
import pytest

from fenet.data import transforms as jt
from fenet.data.shapenet import ShapeNetDataset as JaxShapeNetDataset
from fenet_torch.data import transforms as tt
from fenet_torch.data.shapenet import ShapeNetDataset, load_split
from fenet_torch.data.synthetic import write_synthetic_shapenet


def _state():
    return np.random.RandomState(11)


# name -> (module -> transform); each random transform gets a fresh state
# seeded alike on both sides.
TRANSFORMS = {
    "to_float": lambda m: m.ToFloat(),
    "normalize": lambda m: m.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "center_crop": lambda m: m.CenterCrop(20, 24),
    "center_crop_larger": lambda m: m.CenterCrop(40, 40),
    "random_crop": lambda m: m.RandomCrop(17, 23, rng=_state()),
    "random_flip": lambda m: m.RandomFlip(0.5, rng=_state()),
    "color_jitter": lambda m: m.ColorJitter(rng=_state()),
    "color_jitter_brightness": lambda m: m.ColorJitter(0.4, 0, 0, rng=_state()),
    "random_noise": lambda m: m.RandomNoise(10.0, rng=_state()),
    "salt_pepper": lambda m: m.SaltPepperNoise(0.2, rng=_state()),
    "random_background": lambda m: m.RandomBackground(rng=_state()),
    "compose": lambda m: m.Compose([
        m.RandomCrop(28, 28, rng=np.random.RandomState(1)),
        m.RandomFlip(rng=np.random.RandomState(2)),
        m.ColorJitter(rng=np.random.RandomState(3)),
        m.SaltPepperNoise(0.05, rng=np.random.RandomState(4)),
        m.RandomBackground(rng=np.random.RandomState(5)),
        m.Normalize([0.5, 0.5, 0.5], [0.25, 0.25, 0.25]),
    ]),
}


def _image(dtype):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (32, 32, 3)).astype(dtype)
    img[:8] = 0  # a black background band for RandomBackground
    return img


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_fenet(name, dtype):
    ours, ref = TRANSFORMS[name](tt), TRANSFORMS[name](jt)
    img = _image(dtype)
    for _ in range(3):
        got, want = ours(img.copy()), ref(img.copy())
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_dataset_transform_sample_matches_fenet(tmp_path):
    """The reader hands the transform cv2's uint8 crop: a float32 sample of
    a transformed render equals fenet's, on the same synthetic tree."""
    cat = "02691156"
    write_synthetic_shapenet(str(tmp_path), cats=(cat,), models_per_cat=1, num_points=256)
    models = load_split(str(tmp_path / "splits"), "train_models.json")
    args = (str(tmp_path / "ShapeNetRendering"), str(tmp_path / "ShapeNet_pointclouds"),
            models, [cat], 256)
    ours = ShapeNetDataset(*args, variety=True, transform=TRANSFORMS["compose"](tt))
    ref = JaxShapeNetDataset(*args, variety=True, transform=TRANSFORMS["compose"](jt))
    for i in (0, 5, 23):
        got, want = ours[i], ref[i]
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    assert ours.load_batch([0, 1]) is None  # a transform: the native path declines
