"""Cross-tier config derivation (port of ``transfusion_tpu/config/derive.py``).

Functional equivalent of ``update_config`` + ``get_model_config_from_path``
in the reference launcher (``runner/run_experiment.py:43-62,68-187``): takes
the three YAML tiers (run config, model config, fusion config) and derives
the fields the rest of the stack expects (language feature sizes, fusion
token dim, resize spec propagation, ...). Reference configs pass through
unmodified.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any

from transfusion_torch.config.loader import Config, load_config

# runner/run_experiment.py:43-52
LANG_MODEL_FEATURE_SIZES = {
    "all-distilroberta-v1": 768,
    "all-MiniLM-L12-v2": 384,
    "all-MiniLM-L6-v2": 384,
    "distilgpt2": 768,
    "t5-small": 512,
    "flan-t5-large": 1024,
    "flan-t5-small": 512,
    "slowfast": 2304,
    # Additive (not in the reference table): a tiny BERT for smoke tests.
    "minilm-tiny": 64,
}

# runner/run_experiment.py:53-61
LM_TO_TEXT_POOLING = {
    "all-distilroberta-v1": "sbert_finetune",
    "all-MiniLM-L12-v2": "sbert_finetune",
    "all-MiniLM-L6-v2": "sbert_finetune",
    "distilgpt2": "gpt2",
    "t5-small": "t5-wikihow",
    "flan-t5-small": "t5-wikihow",
    "flan-t5-large": "t5-wikihow",
    "minilm-tiny": "sbert_finetune",
}

# modeling/narration_embeds/narr_pooling_layers.py:20
LEARNABLE_LM = {"sbert_finetune", "gpt2", "t5-wikihow", "slowfast"}

DEBUG_BS = 10  # runner/run_experiment.py:62


def _load_model_config(model_config_path: str, config: Config) -> dict:
    """Mirror of get_model_config_from_path (runner/run_experiment.py:165-187)."""
    model_config = dict(load_config(model_config_path))
    if "pretrained" not in model_config:
        model_config["pretrained"] = config.get("pretrained")
    if "finetune" not in model_config:
        model_config["finetune"] = config.get("finetune")
    return model_config


def derive_config(config: Config, overrides: dict[str, Any] | None = None) -> Config:
    """Merge fusion/model configs into the run config and derive fields.

    ``overrides`` maps CLI-flag names (debug, devices, resume_from, ...) onto
    the config the same way argparse flags do in the reference
    (runner/run_experiment.py:297-301).
    """
    overrides = overrides or {}

    config.set("date", datetime.now().strftime("%m/%d/%Y, %H:%M:%S"))
    config.set("debug", bool(config.get("debug")) or bool(overrides.get("debug")))
    config.set("force_wandb_logging", config.get("force_wandb_logging", False))

    run_args = config["run"]

    # Fold the fusion config file into run.narr_fusion (run_experiment.py:75-77).
    narr_f_config_path = run_args["narr_fusion"]["config"]
    run_args["narr_fusion"].update(dict(load_config(narr_f_config_path)))

    run_args["resumed_from"] = overrides.get("resume_from", "")
    run_args["resumed_from_name"] = overrides.get("resume_from_name", "")

    if overrides.get("devices") is not None:
        run_args["devices"]["devices"] = overrides["devices"]

    # Language feature sizing (run_experiment.py:85-126).
    narr_args = run_args["narration_embeds"]["args"]
    narr_args["text_pooling"] = LM_TO_TEXT_POOLING[narr_args["model_v"]]
    if run_args["narration_embeds"].get("slowfast_f", False):
        narr_args["text_pooling"] = "slowfast"
        narr_args["model_v"] = "slowfast"

    if narr_args["pooling"] == "sbert" or narr_args["text_pooling"] in LEARNABLE_LM:
        if narr_args.get("out_mlp"):
            run_args["narr_fusion"]["args"]["input_f_size"] = narr_args["out_mlp"]
            narr_args["size"] = LANG_MODEL_FEATURE_SIZES[narr_args["model_v"]]
        else:
            run_args["narr_fusion"]["args"]["input_f_size"] = LANG_MODEL_FEATURE_SIZES[narr_args["model_v"]]
            narr_args["size"] = LANG_MODEL_FEATURE_SIZES[narr_args["model_v"]]

        if run_args["narr_fusion"].get("model") == "cross_f_shared":
            run_args["narr_fusion"]["args"]["back_to_img_fn"] = "token"
        if run_args["criterion"].get("multivar_n", 0):
            run_args["narr_fusion"]["args"]["back_to_img_fn"] = "token"
    else:
        run_args["narr_fusion"]["args"]["input_f_size"] = narr_args["size"]

    if narr_args["text_pooling"] in LEARNABLE_LM:
        narr_args["finetune"] = False

    # Legacy heatmap criteria coupling (run_experiment.py:128-139); kept so the
    # historical snao configs derive identically even though the egonao path
    # never reads these fields.
    criterion = run_args["criterion"]
    if criterion.get("kl_div", 0):
        run_args["hmap_scaling"] = "sum"
        criterion["agg"] = "sum"
        run_args["heatmap_type"] = "gaussian_dist"
    if criterion.get("multivar_n", 0):
        run_args["heatmap_type"] = "gaussian_dist"
        run_args["metric_norm"] = True
    if criterion.get("mae", 0):
        run_args["heatmap_type"] = "gaussian"

    run_args["resize_spec"] = config["aug"]["resize_spec"]
    run_args["channel_order"] = config["aug"].get("channel_order", "RGB")
    run_args["dataset"] = config["dataset"]["name"]

    # Model-config tier (run_experiment.py:145-148).
    model_config_path = config["model"]
    model_config = _load_model_config(model_config_path, config)
    model_config["verb_classifier"]["hand_args"] = run_args.get("hand_args", {"use": False})
    config.set("model", model_config)

    run_args["experiment"] = config["experiment"]
    config.set("run", run_args)

    config.set(
        "_files_to_log",
        {
            "narr_fusion_config": narr_f_config_path,
            "model_config": model_config_path,
            **{
                f"external_narrs_{idx}": path
                for idx, path in enumerate(config["dataset"]["args"].get("narr_external_paths", []))
            },
        },
    )
    return config
