"""The port's train step is a function of (params, batch, seed, step): its
dropout draws from the step's ``DropoutRNG`` (keep masks, and attention
kernel K2's seeds from a CPU generator), never from torch's global
generators, so a resumed run replays its steps, as JAX folds the step into
its key. On the CPU, on a tiny model (frozen backbone) with every dropout
site on (MiniLM's four and its output projection's, the fusion's patch,
attention, residual-branch and back-projection dropouts, the RoI heads'
three) and the flash gate lowered so that the tiny fusion sequence takes
K2's path with its seed; the samplers' draws are passed in, so only dropout
can tell two steps apart."""

import dataclasses

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tests.torch_threads import cap_torch_threads  # noqa: F401
from transfusion_torch.models import fusion
from transfusion_torch.models import text_encoder as te
from transfusion_torch.models.detector import DetectorConfig
from transfusion_torch.models.roi_heads import RoIConfig
from transfusion_torch.models.rpn import RPNConfig
from transfusion_torch.models.transfusion import FusionConfig, TransFusion, TransFusionConfig
from transfusion_torch.train.optim import make_optimizer
from transfusion_torch.train.step import LossConfig, TrainState, criterion_weights, make_train_step
from transfusion_torch.weights import init_random_

H, W, B = 32, 64, 2


def _model():
    cfg = TransFusionConfig(
        detector=DetectorConfig(
            roi=RoIConfig(num_nouns=7, num_verbs=5, representation_size=32, batch_size_per_image=8,
                          detections_per_img=10, box_1_dropout=0.1, box_2_dropout=0.1, classif_dropout=0.1),
            rpn=RPNConfig(pre_nms_top_n_train=32, post_nms_top_n_train=16),
            stage_sizes=(1, 1, 1, 1), stop_grad_stages=5),
        fusion=FusionConfig(fpn_features=(1,), patch_h=(2,), patch_w=(2,), num_layers=(1,), token_dim=16,
                            num_heads=2, use_flash_attention=True),
        bert=te.BertConfig(vocab_size=64, hidden_size=8, num_layers=1, num_heads=2, intermediate_size=32,
                           max_position_embeddings=16),
        out_mlp=16)
    return init_random_(TransFusion(cfg, device="cpu"), seed=3), cfg


def _batch(gen):
    batch = {"image": torch.randn(B, H, W, 3, generator=gen),
             "input_ids": torch.randint(0, 64, (B, 8), generator=gen),
             "attention_mask": torch.ones(B, 8, dtype=torch.int64), "image_hw": (H, W),
             "targets": {"boxes": torch.tensor([[[2.0, 3.0, 20.0, 15.0], [25.0, 5.0, 60.0, 30.0]],
                                                [[1.0, 1.0, 15.0, 11.0], [0.0, 0.0, 0.0, 0.0]]]),
                         "nouns": torch.tensor([[2, 5], [1, 0]]), "verbs": torch.tensor([[1, 3], [4, 0]]),
                         "ttcs": torch.tensor([[0.5, 1.5], [0.9, 0.0]]),
                         "valid": torch.tensor([[True, True], [True, False]])}}
    batch["attention_mask"][1, 6:] = 0
    return batch


def test_train_step_replays_from_seed_and_step(monkeypatch):
    monkeypatch.setattr(fusion, "FLASH_MIN_LEN", 16)  # the 8 + 8 token sequence takes K2's path
    seeds = []
    draw_seed = te.DropoutRNG.attention_seed
    monkeypatch.setattr(te.DropoutRNG, "attention_seed", lambda self: seeds.append(draw_seed(self)) or seeds[-1])
    model, cfg = _model()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(5)
    batch = _batch(gen)
    with torch.no_grad():
        anchors = model(batch)["proposals"]["anchors"].shape[0]
    n_roi = cfg.detector.rpn.post_nms_top_n_train + 2
    draws = {"roi": tuple(torch.rand(B, n_roi, generator=gen) for _ in range(2)),
             "rpn": tuple(torch.rand(B, anchors, generator=gen) for _ in range(2))}
    lw = criterion_weights({"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1})

    def step(at: int, disturb: int):
        model.load_state_dict(start)
        tx, _ = make_optimizer({"name": "radam", "lr": 1e-3, "weight_decay": 1e-4}, None, 10)
        state = TrainState(step=at, opt_state=tx.init(dict(model.named_parameters())), seed=11)
        fn = make_train_step(model, tx, LossConfig(rpn_batch_size_per_image=16, last_noun_idx=6),
                             torch.ones(7), torch.ones(5))
        torch.manual_seed(disturb)  # the global generators, disturbed differently before each step
        torch.rand(disturb)
        metrics = fn(state, batch, lw, None, draws)
        assert metrics["nonfinite_skipped"] == 0.0 and state.step == at + 1
        return {k: p.detach().clone() for k, p in model.named_parameters()}

    first, again, later = step(3, 1), step(3, 2), step(4, 1)
    assert len(seeds) == 3 and seeds[0] == seeds[1] != seeds[2]
    assert all(torch.equal(first[k], again[k]) for k in first)
    # Every site's branch: MiniLM, the fusion layer (K2's seed and the masks),
    # the back-projection and the RoI heads.
    for name in ("narr_pooling_layer.encoder.0.auto_model.encoder.layer.0.attention.self.query.weight",
                 "narr_pooling_layer.out_mlp.weight",
                 "cross_fusion_encoders.0.t_encoder.layers.0.self_attn.in_proj_weight",
                 "tokens_to_features.0.linear.weight", "roi_heads.noun_classifier.weight"):
        assert not torch.equal(first[name], later[name]), name


@pytest.mark.parametrize("family, fusion_kw, model_kw, watched", [
    ("asymmetric", dict(fusion_type="asymmetric", asymm_lang_layers=1), dict(lm_on=True),
     "cross_fusion_encoders.0.lang_layers.0.q_proj.weight"),
    ("space_time", dict(fusion_type="space_time"), {},
     "cross_fusion_encoders.0.encoder.layers.0.temporal.linear1.weight"),
])
def test_fusion_option_steps_replay_from_seed_and_step(family, fusion_kw, model_kw, watched):
    """The new families' dropout sites (the QKV layers' four, the
    space-time layers', their patch and back-projection dropouts; the clip
    fusion's layers are the EncoderLayer the test above covers) draw from
    the step's DropoutRNG too: the same (seed, step) gives the same
    parameters with torch's global generators disturbed, another step moves
    a new layer elsewhere."""
    base, cfg = _model()
    cfg = dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, **fusion_kw), **model_kw)
    model = init_random_(TransFusion(cfg, device="cpu"), seed=3)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(6)
    batch = _batch(gen)
    with torch.no_grad():
        anchors = model(batch)["proposals"]["anchors"].shape[0]
    n_roi = cfg.detector.rpn.post_nms_top_n_train + 2
    draws = {"roi": tuple(torch.rand(B, n_roi, generator=gen) for _ in range(2)),
             "rpn": tuple(torch.rand(B, anchors, generator=gen) for _ in range(2))}
    lw = criterion_weights({"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1, "lm": 1})

    def step(at: int, disturb: int):
        model.load_state_dict(start)
        tx, _ = make_optimizer({"name": "radam", "lr": 1e-3}, None, 10)
        state = TrainState(step=at, opt_state=tx.init(dict(model.named_parameters())), seed=11)
        fn = make_train_step(model, tx, LossConfig(lm_on=cfg.lm_on, rpn_batch_size_per_image=16,
                                                   last_noun_idx=6), torch.ones(7), torch.ones(5))
        torch.manual_seed(disturb)
        torch.rand(disturb)
        assert fn(state, batch, lw, None, draws)["nonfinite_skipped"] == 0.0
        return {k: p.detach().clone() for k, p in model.named_parameters()}

    first, again, later = step(3, 1), step(3, 2), step(4, 1)
    assert all(torch.equal(first[k], again[k]) for k in first), family
    assert not torch.equal(first[watched], later[watched]), watched


@pytest.mark.parametrize("family, fusion_kw, model_kw", [
    ("cross_transformer", dict(share_encoders=True, forward_language_f="sum"),
     dict(use_visual_features=True, visual_feature_layers=1)),
    ("asymmetric", dict(fusion_type="asymmetric", asymm_lang_layers=1), dict(lm_on=True)),
    ("space_time", dict(fusion_type="space_time"), {}),
])
def test_remat_step_equals_plain_step(monkeypatch, family, fusion_kw, model_kw):
    """``remat_fusion`` recomputes each fusion level in the backward on the
    step's own draws: over two levels (the cross-transformer's with its
    shared stack and clip-feature fusion; level 1's 8 + 8 tokens take K2's
    path with its seed, level 2's 2 + 8 the plain attention with its keep
    mask) with every dropout site on, the remat step gives the loss and
    every parameter bit for bit (torch.equal) as the plain step does, and
    the K2 seeds the step's DropoutRNG yields are the plain step's, drawn
    again in the recompute. Only a training forward with autograd
    recording checkpoints: a training forward under no_grad, an eval
    forward and eval_with_losses (the last two checked once) run every
    level plainly."""
    from transfusion_torch.models import transfusion as tf

    monkeypatch.setattr(fusion, "FLASH_MIN_LEN", 16)
    seeds = []
    draw_seed = te.DropoutRNG.attention_seed
    monkeypatch.setattr(te.DropoutRNG, "attention_seed", lambda self: seeds.append(draw_seed(self)) or seeds[-1])
    checkpoints = []
    monkeypatch.setattr(tf, "checkpoint", lambda *a, **k: checkpoints.append(None) or checkpoint(*a, **k))
    _, cfg = _model()
    # 16 proposals an image at test time too: the plain RoIAlign over 1,000 is most of an eval forward.
    rpn = dataclasses.replace(cfg.detector.rpn, pre_nms_top_n_test=32, post_nms_top_n_test=16)
    cfg = dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, rpn=rpn),
        fusion=dataclasses.replace(cfg.fusion, fpn_features=(1, 2), patch_h=(2, 2), patch_w=(2, 2),
                                   num_layers=(1, 1), **fusion_kw), **model_kw)
    model = init_random_(TransFusion(cfg, device="cpu"), seed=3)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(7)
    batch = _batch(gen)
    if cfg.use_visual_features:
        batch["visual_features"] = torch.randn(B, 3, cfg.visual_feature_dim, generator=gen)
    remat_model = dataclasses.replace(cfg, remat_fusion=True)
    model.tcfg = remat_model
    with torch.no_grad():
        anchors = model.train()(batch, train=True, rng=te.DropoutRNG("cpu", 1, 0))["proposals"]["anchors"].shape[0]
        if family == "cross_transformer":
            model.eval()(batch)
            model.eval_with_losses(batch)
    assert checkpoints == [], family
    n_roi = cfg.detector.rpn.post_nms_top_n_train + 2
    draws = {"roi": tuple(torch.rand(B, n_roi, generator=gen) for _ in range(2)),
             "rpn": tuple(torch.rand(B, anchors, generator=gen) for _ in range(2))}
    lw = criterion_weights({"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1, "lm": 1})

    def step(remat: bool):
        model.tcfg = remat_model if remat else cfg
        model.load_state_dict(start)
        tx, _ = make_optimizer({"name": "radam", "lr": 1e-3}, None, 10)
        state = TrainState(step=3, opt_state=tx.init(dict(model.named_parameters())), seed=11)
        fn = make_train_step(model, tx, LossConfig(lm_on=cfg.lm_on, rpn_batch_size_per_image=16,
                                                   last_noun_idx=6), torch.ones(7), torch.ones(5))
        seeds.clear()
        metrics = fn(state, batch, lw, None, draws)
        assert metrics["nonfinite_skipped"] == 0.0
        return {k: p.detach().clone() for k, p in model.named_parameters()}, metrics["loss"], list(seeds)

    plain, plain_loss, plain_seeds = step(False)
    assert checkpoints == []
    remat, remat_loss, remat_seeds = step(True)
    assert len(checkpoints) == 2, family
    assert torch.equal(plain_loss, remat_loss), family
    moved = [k for k in plain if not torch.equal(plain[k], start[k])]
    assert len(moved) > len(plain) // 2, family
    differ = [k for k in plain if not torch.equal(plain[k], remat[k])]
    assert differ == [], (family, differ)
    k2 = int(family == "cross_transformer")  # the other families' layers have no K2 path
    assert len(plain_seeds) == k2 and remat_seeds == plain_seeds * 2, (family, plain_seeds, remat_seeds)
