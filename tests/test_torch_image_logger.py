"""The port's image logger (`adaface_tpu_torch/training/image_logger.py`)
against `adaface_tpu/training/image_logger.py`: `add_border` and
`make_grid` (with and without verdict colors, a ragged tail) equal JAX's
bit for bit; every `ImageLogger` file is a PNG (the JAX logger writes
JPEG) that reads back as the grid bit for bit; `log_samples` grids the
pipeline's own images; the trainer's `set_image_logger` makes one."""

import os

import numpy as np
import pytest

from adaface_tpu.training import image_logger as jlog

from adaface_tpu_torch.data import png
from adaface_tpu_torch.training import image_logger as tlog


def _images(n, seed=0, size=12):
    return list(np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8))


@pytest.mark.parametrize("color,width", [(None, 4), ((255, 0, 0), 4), ((160, 32, 240), 2)])
def test_add_border_matches_jax(color, width):
    im = _images(1)[0]
    np.testing.assert_array_equal(tlog.add_border(im, color, width),
                                  jlog.add_border(im, color, width))


@pytest.mark.parametrize("n,ncol,colors", [(1, 4, None), (6, 4, None), (8, 3, [0, 1, 2, 3] * 2),
                                           (5, 2, [2, 1, 1, 3, 0])])
def test_make_grid_matches_jax(n, ncol, colors):
    ims = _images(n, seed=n)
    np.testing.assert_array_equal(tlog.make_grid(ims, ncol, colors),
                                  jlog.make_grid(ims, ncol, colors))


class _Pipe:
    """Stands in for a pipeline: `generate` returns seeded images."""

    def generate(self, prompts, num_steps, height, width, seed):
        self.call = (list(prompts), num_steps, height, width, seed)
        return np.random.default_rng(seed).integers(0, 256, (len(prompts), height, width, 3),
                                                    dtype=np.uint8)


def test_logger_writes_pngs_that_read_back(tmp_path):
    lg = tlog.ImageLogger(str(tmp_path), every_steps=5, num_samples=3, sample_steps=7, size=16)
    assert [lg.should_log(s) for s in (0, 3, 5, 10)] == [True, False, True, True]
    assert not tlog.ImageLogger(str(tmp_path), every_steps=0).should_log(0)
    ims = np.stack(_images(5, seed=2))
    path = lg.log_inputs(12, ims)
    assert os.path.basename(path) == "inputs_gs-000012.png"
    np.testing.assert_array_equal(png.read(path), jlog.make_grid(list(ims)))
    path = lg.log_candidates(3, ims, [2, 1, 1, 3, 0])
    assert os.path.basename(path) == "candidates_gs-000003.png"
    np.testing.assert_array_equal(png.read(path), jlog.make_grid(list(ims), colors=[2, 1, 1, 3, 0]))
    pipe = _Pipe()
    imgs = lg.log_samples(40, pipe, "a photo of a z", seed=4, tag="val_samples")
    assert pipe.call == (["a photo of a z"] * 3, 7, 16, 16, 4)
    np.testing.assert_array_equal(
        png.read(os.path.join(lg.dir, "val_samples_gs-000040.png")), tlog.make_grid(list(imgs)))
    assert sorted(os.listdir(lg.dir)) == ["candidates_gs-000003.png", "inputs_gs-000012.png",
                                          "val_samples_gs-000040.png"]
