"""Train/val/test split handling (port of ``transfusion_tpu/data/splits.py``;
pandas imported where a function needs it).

Subset 0 (the shipped configs, ``split.subset: 0``) uses the Ego4D challenge
split recorded in ``orig_split`` (``train_test_splits/utils.py:137-144``);
generated CSV splits (subsets 1-3) load ``subset_{n}`` columns from the
split CSVs. ``apply_split`` reproduces the class-coverage asserts
(``runner/nao/snao_data.py:116-120``) and the all-as-train/val overrides.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import pandas as pd


def load_split(annots: pd.DataFrame, split_cfg: dict, splits_dir: str | None = None) -> pd.DataFrame:
    """Returns a DataFrame indexed by nao_clip_id with a 'subset' column."""
    subset = split_cfg.get("subset", 0)
    if subset == 0:
        df = annots[["orig_split", "nao_narration"]].copy()
        df = df.rename(columns={"orig_split": "subset"})
        df.index.name = "nao_clip_id"
        return df
    if splits_dir is None:
        raise ValueError("generated splits (subset != 0) need splits_dir")
    import os

    import pandas as pd

    name = f"snao_{split_cfg['type']}_{split_cfg.get('nao_version', 1)}_{split_cfg['version']}"
    if split_cfg.get("strat_col"):
        name += f"_{split_cfg['strat_col']}"
    path = os.path.join(splits_dir, name + ".csv")
    df = pd.read_csv(path, index_col="nao_clip_id")[[f"subset_{subset}", "nao_narration"]]
    return df.rename(columns={f"subset_{subset}": "subset"})


def subsample_split(split_df: pd.DataFrame, spec, seed: int) -> pd.DataFrame:
    """Stratified subsampling by nao_narration (train_test_splits/utils.py:43-84)."""
    import pandas as pd

    if spec is None:
        return split_df

    def sample(df, n):
        if isinstance(spec, float) or spec == 1:
            n = int(spec * len(df))
        counts = df["nao_narration"].value_counts()
        w = df["nao_narration"].map(counts / len(df)).to_numpy()
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(df), size=int(n), replace=False, p=w)
        return df.iloc[idx]

    if isinstance(spec, str):
        n_train, n_val, n_test = (int(x) for x in spec.split("_"))
    else:
        n_train = n_val = n_test = None
    parts = []
    for name, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        part = split_df[split_df["subset"] == name]
        if len(part):
            parts.append(sample(part, n))
    return pd.concat(parts)


def apply_split(annots: pd.DataFrame, split_df: pd.DataFrame, split_cfg: dict | None = None):
    """Slice annotations into (train, val, test) frames with coverage checks."""
    split_cfg = split_cfg or {}

    def part(name):
        ids = set(split_df[split_df["subset"] == name].index)
        return annots[annots["nao_clip_id"].isin(ids)]

    train, val, test = part("train"), part("val"), part("test")
    if len(test) == 0:
        val_ids = split_df[split_df["subset"] == "val"].index.tolist()[:1000]
        test = annots[annots["nao_clip_id"].isin(set(val_ids))]

    if split_cfg.get("all_samples_as_val"):
        val = train
    elif split_cfg.get("all_samples_as_train"):
        train = annots[~annots["nao_clip_id"].isin(set(split_df[split_df["subset"] == "test"].index))]
        val = test

    # Class-coverage check. The reference's asserts (snao_data.py:116-120)
    # compare the slicer's mapping against itself — vacuously true — so real
    # gaps only warn here rather than abort.
    import warnings

    train_nouns = set(train["all_nouns"].explode())
    train_verbs = set(train["all_verbs"].explode())
    for name, d in (("val", val), ("test", test)):
        missing_n = set(d["all_nouns"].explode()) - train_nouns
        missing_v = set(d["all_verbs"].explode()) - train_verbs
        if missing_n or missing_v:
            warnings.warn(f"{name} classes unseen in train: nouns={missing_n} verbs={missing_v}")
    return train, val, test
