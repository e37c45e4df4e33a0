"""Label mappings, class weights, and noun-verb co-occurrence frequencies
(port of ``transfusion_tpu/data/labels.py``; pandas is imported where a
function needs it).

Mirrors ``data_preprocessing/utils/dataset_utils.py:82-143`` (external label
mapping with the noun 0 -> highest+1 remap and generated additions) and
``data_preprocessing/datasets/commons.py:69-170`` (balanced class weights
with dampening exponents; noun->verb train frequencies feeding the
additional-postprocessing verb replacement).
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import pandas as pd


def generated_label_mapping(values, word_type: str = "noun") -> dict[str, int]:
    """Generated mapping sorted by name. Nouns are 1-based (0 reserved for
    background, like the reference generator); verbs are 0-based — the
    reference generates 1-based verbs too (dataset_utils.py:84-86), but its
    verb background convention is LAST index, so 1-based verb ids collide
    with bg in the never-exercised generated path; the external-mapping path
    (the shipped configs) uses 0-based verbs, which we follow here."""
    import pandas as pd

    offset = 1 if word_type == "noun" else 0
    return {k: i + offset for i, k in enumerate(sorted(pd.unique(values)))}


def external_label_mapping(values, word_type: str, mapping_file: str) -> dict[str, int]:
    import pandas as pd

    with open(mapping_file) as fp:
        mapping_dict = json.load(fp)
    base = mapping_dict.get("ego4d", {}).get(word_type, {})
    ret = dict(base)

    highest = max(ret.values()) if ret else 0
    if word_type == "noun":
        zero_words = [k for k, v in ret.items() if v == 0]
        if zero_words:
            highest += 1
            for w in zero_words:
                ret[w] = highest  # 0 reserved for background

    for w in sorted(pd.unique(values)):
        if w not in ret:
            highest += 1
            ret[w] = highest
    return ret


def get_label_mapping(values, word_type: str, mapping_file: str | None) -> dict[str, int]:
    if mapping_file:
        return external_label_mapping(values, word_type, mapping_file)
    return generated_label_mapping(values, word_type)


def balanced_class_weights(
    exploded_labels: pd.Series,
    full_mapping: dict[str, int],
    dampen: float,
) -> np.ndarray:
    """commons.py:69-101: sklearn-style balanced weights indexed by class id;
    classes missing from the split get the mean; then ``** dampen``."""
    max_val = max(full_mapping.values())
    weights = np.ones(max_val + 1)

    counts = exploded_labels.value_counts()
    present = sorted(set(full_mapping) & set(counts.index))
    if present:
        n_samples = int(counts[present].sum())
        n_classes = len(present)
        bal = {c: n_samples / (n_classes * counts[c]) for c in present}
        for name, w in bal.items():
            weights[full_mapping[name]] = w

    missing_ids = [i for k, i in full_mapping.items() if k not in set(counts.index)]
    if missing_ids:
        weights[missing_ids] = weights.mean()
    return weights**dampen


def noun_verb_frequencies(
    annots: pd.DataFrame, noun_mapping: dict[str, int], verb_mapping: dict[str, int]
) -> dict[int, dict[int, int]]:
    """Train noun->verb co-occurrence counts (commons.py:154-170)."""
    ret: dict[int, dict[int, int]] = {}
    for _, row in annots.iterrows():
        for noun, verb in zip(row["all_nouns"], row["all_verbs"]):
            n_id = noun_mapping[noun]
            v_id = verb_mapping[verb]
            ret.setdefault(n_id, {})[v_id] = ret.get(n_id, {}).get(v_id, 0) + 1
    return ret


def frequencies_to_array(freqs: dict, num_nouns: int, num_verbs: int) -> np.ndarray:
    arr = np.zeros((num_nouns, num_verbs), np.float32)
    for n_id, verb_counts in freqs.items():
        for v_id, c in verb_counts.items():
            arr[n_id, v_id] = c
    return arr


def merge_labels(annots: pd.DataFrame, merging: dict[str, dict[str, str]]) -> pd.DataFrame:
    """dataset_utils.py:153-160 — present for API completeness; NOTE the
    reference never invokes this on the egonao path (the label_merging config
    is loaded and stored but inert, base_nao_dataset.py:58), so callers on
    the Ego4D path should not apply it either."""
    if merging:
        for category, syn in merging.items():
            annots[category] = annots[category].map(lambda x: syn.get(x, x))
    return annots


def drop_rare_labels(annots: pd.DataFrame, cutoff: dict) -> pd.DataFrame:
    """dataset_utils.py:163-178."""
    if not cutoff or not cutoff.get("drop"):
        return annots
    for key in ("noun", "verb"):
        if cutoff["drop"] is True:
            counts = annots[key].value_counts()
            keep = counts[counts >= cutoff[key]].index
            annots = annots[annots[key].isin(keep)]
        elif str(cutoff["drop"]).lower() == "top":
            if cutoff[key]:
                counts = annots[key].value_counts()
                annots = annots[annots[key].isin(counts[: cutoff[key]].index)]
    return annots
