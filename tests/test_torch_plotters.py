"""The port's plot callbacks (``runner/callbacks.py``) against the JAX
package's on the CPU: the same inputs give the same decoded pixels (PNG
through ``plot_*_grid``, the plotters' JPEG files), exactly; and the
trainer's wiring: a plot of the first validation batch an evaluation, no
plotter without matplotlib (``test_torch_trainer.py``'s run without the
file packages evaluates without one), and a plot that fails never breaks
the evaluation."""

import os
import sys

import numpy as np
import pytest

from tests.torch_threads import cap_torch_threads  # noqa: F401


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _batch(rng, n=3, hw=(40, 56)):
    """A normalised batch with targets and detections in the trainer's layout."""
    k, g = 6, 2
    xy = rng.uniform(0, 20, (n, k, 2))
    gxy = rng.uniform(0, 20, (n, g, 2))
    batch = {"image": rng.normal(0, 0.7, (n, *hw, 3)).astype(np.float32),
             "targets": {"boxes": np.concatenate([gxy, gxy + 15], -1).astype(np.float32),
                         "nouns": rng.integers(1, 5, (n, g)), "verbs": rng.integers(0, 4, (n, g)),
                         "valid": np.array([[True, True], [True, False], [False, False]])[:n]}}
    dets = {"boxes": np.concatenate([xy, xy + rng.uniform(5, 30, (n, k, 2))], -1).astype(np.float32),
            "scores": rng.uniform(0, 1, (n, k)).astype(np.float32), "nouns": rng.integers(0, 6, (n, k)),
            "verbs": rng.integers(0, 5, (n, k)), "ttcs": rng.uniform(0, 2, (n, k)).astype(np.float32),
            "valid": rng.uniform(0, 1, (n, k)) > 0.3}
    return batch, dets


@pytest.mark.parametrize("normalization", ["ego4d_baseline", "imagenet"])
def test_box_grids_match_jax_pixel_for_pixel(tmp_path, normalization):
    """denormalize_image, plot_boxes_grid (PNG, both channel orders, a
    partly filled grid) and BboxPlotter's JPEG give JAX's pixels."""
    from transfusion_torch.runner import callbacks as T
    from transfusion_tpu.runner import callbacks as J

    rng = np.random.default_rng(0)
    batch, dets = _batch(rng)
    img = batch["image"][0]
    np.testing.assert_array_equal(T.denormalize_image(img, normalization),
                                  J.denormalize_image(img, normalization))
    gt = [b[v] for b, v in zip(batch["targets"]["boxes"], batch["targets"]["valid"])]
    pred = [b[:2] for b in dets["boxes"]]
    labels = [["cup/take 0.50s 0.91", "pan"], ["knife"], []]
    for order in ("BGR", "RGB"):
        paths = [str(tmp_path / f"{p}_{order}.png") for p in ("port", "jax")]
        for mod, path in zip((T, J), paths):
            assert mod.plot_boxes_grid(batch["image"], gt, pred, labels, ["a", "b", "c"], path, cols=2,
                                       normalization=normalization, channel_order=order) == path
        np.testing.assert_array_equal(_pixels(paths[0]), _pixels(paths[1]))

    nouns, verbs = {i: f"noun{i}" for i in range(6)}, {i: f"verb{i}" for i in range(5)}
    outs = [mod.BboxPlotter(str(tmp_path / name), nouns, verbs, normalization=normalization)(
        "val", 3, batch, dets) for mod, name in ((T, "port"), (J, "jax"))]
    assert outs[0] == str(tmp_path / "port" / "plots" / "val" / "epoch_003.jpg")
    np.testing.assert_array_equal(_pixels(outs[0]), _pixels(outs[1]))


def test_heatmap_grids_match_jax_pixel_for_pixel(tmp_path):
    """plot_heatmap_grid (PNG, with titles) and HmapPlotter's JPEG give JAX's pixels."""
    from transfusion_torch.runner import callbacks as T
    from transfusion_tpu.runner import callbacks as J

    rng = np.random.default_rng(1)
    images = rng.normal(0, 0.7, (2, 32, 48, 3)).astype(np.float32)
    gt, pred = rng.uniform(0, 1, (2, 2, 8, 12)).astype(np.float32)
    paths = [str(tmp_path / f"{p}.png") for p in ("port", "jax")]
    for mod, path in zip((T, J), paths):
        mod.plot_heatmap_grid(images, gt, pred, titles=["x", "y"], out_path=path, channel_order="RGB")
    np.testing.assert_array_equal(_pixels(paths[0]), _pixels(paths[1]))
    outs = [mod.HmapPlotter(str(tmp_path / name))("val", 2, images, gt, pred)
            for mod, name in ((T, "port"), (J, "jax"))]
    assert outs[0].endswith(os.path.join("plots", "val", "hmap_epoch_2.jpg"))
    np.testing.assert_array_equal(_pixels(outs[0]), _pixels(outs[1]))


def test_trainer_plots_the_first_val_batch_and_survives_a_failed_plot(tmp_path, monkeypatch):
    """evaluate() plots its first validation batch with BboxPlotter (the
    plot equal to the plotter's own on that batch and the eval step's
    detections); a plotter that raises leaves the metrics as they were;
    without matplotlib the trainer builds no plotter."""
    from tests.torch_parallel_workers import _tp_trainer, tiny_data, tiny_run_config
    from transfusion_torch.data.loader import DataLoader
    from transfusion_torch.runner.callbacks import BboxPlotter

    data = tiny_data()
    trainer = _tp_trainer(tiny_run_config(), str(tmp_path / "run"), device="cpu", data=data)
    assert isinstance(trainer.plotter, BboxPlotter)
    first = trainer.evaluate(0)
    assert trainer.last_plot_path == str(tmp_path / "run" / "plots" / "val" / "epoch_000.jpg")

    loader = DataLoader(data.val_ds, trainer.val_bs, tokenizer=trainer.tokenizer, training=False,
                        seed=trainer.seed, lang_max_length=trainer.tokenizer.max_length, drop_last=False)
    batch = next(iter(loader))
    loader.close()
    dets, _ = trainer.eval_loss_step(trainer._device_batch(batch), trainer.val_loss_w)
    again = trainer.plotter("check", 0, {"image": batch["image"][:8], "targets": batch["targets"]},
                            {k: v[:8].numpy() for k, v in dets.items()})
    np.testing.assert_array_equal(_pixels(again), _pixels(trainer.last_plot_path))

    def broken(*args):
        raise RuntimeError("no display")

    trainer.plotter = broken
    assert trainer.evaluate(0).metrics == pytest.approx(first.metrics, nan_ok=True)
    assert trainer.last_plot_path is None

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    trainer._build_plotter()
    assert trainer.plotter is None
