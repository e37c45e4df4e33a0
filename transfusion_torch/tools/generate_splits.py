"""Offline stratified/group-stratified split CSV generation
(``data_preprocessing/train_test_splits/snao_train_test_split.py`` equivalent):
writes ``snao_{type}_{version}_{seed}[_{strat}].csv`` files with
``subset_{n}`` columns consumable by ``data.splits.load_split``.

Port of ``transfusion_tpu/tools/generate_splits.py``. It reads the
annotations through the port's ``data.annotations``; pandas and
scikit-learn are imported inside the functions that use them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def generate_split(
    annots,
    split_type: str = "group_stratified",
    strat_col: str | None = "noun",
    n_subsets: int = 3,
    val_frac: float = 0.15,
    test_frac: float = 0.05,
    seed: int = 42,
):
    """Returns a DataFrame indexed by nao_clip_id with subset_1..n columns."""
    import pandas as pd
    from sklearn.model_selection import GroupShuffleSplit, StratifiedGroupKFold

    df = annots[["nao_clip_id", "nao_narration", "clip_id"]].copy()
    y = annots[strat_col] if strat_col and strat_col in annots else annots["nao_narration"]
    groups = annots["clip_id"].astype(str)  # test rows carry uid strings as clip ids

    out = pd.DataFrame({"nao_clip_id": df["nao_clip_id"], "nao_narration": df["nao_narration"]})
    rng = np.random.default_rng(seed)
    for s in range(1, n_subsets + 1):
        labels = np.array(["train"] * len(df), dtype=object)
        if split_type == "group_stratified":
            k = max(int(round(1 / (val_frac + test_frac))), 2)
            skf = StratifiedGroupKFold(n_splits=k, shuffle=True, random_state=seed + s)
            codes = pd.factorize(y)[0]
            _, holdout = next(iter(skf.split(df, codes, groups)))
        else:
            gss = GroupShuffleSplit(n_splits=1, test_size=val_frac + test_frac, random_state=seed + s)
            _, holdout = next(iter(gss.split(df, groups=groups)))
        holdout = np.asarray(holdout)
        # Split the holdout into test/val at CLIP granularity so a clip never
        # straddles subsets.
        holdout_clips = np.array(sorted(set(groups.iloc[holdout])))
        rng.shuffle(holdout_clips)
        n_test_clips = int(len(holdout_clips) * test_frac / (val_frac + test_frac))
        test_clips = set(holdout_clips[:n_test_clips])
        for i in holdout:
            labels[i] = "test" if groups.iloc[i] in test_clips else "val"
        out[f"subset_{s}"] = labels
    return out.set_index("nao_clip_id")


def main(argv=None):
    from transfusion_torch.data.annotations import load_sta_annotations

    parser = argparse.ArgumentParser()
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--split-type", default="group_stratified")
    parser.add_argument("--strat-col", default="noun")
    parser.add_argument("--nao-version", default="1")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--out-dir", default=None)
    args = parser.parse_args(argv)

    annots = load_sta_annotations(args.data_root)
    split = generate_split(annots, args.split_type, args.strat_col, seed=args.seed)
    out_dir = args.out_dir or os.path.join(args.data_root, "splits")
    os.makedirs(out_dir, exist_ok=True)
    name = f"snao_{args.split_type}_{args.nao_version}_{args.seed}"
    if args.strat_col:
        name += f"_{args.strat_col}"
    path = os.path.join(out_dir, name + ".csv")
    split.to_csv(path)
    print(f"wrote {path} ({len(split)} rows)")


if __name__ == "__main__":
    main()
