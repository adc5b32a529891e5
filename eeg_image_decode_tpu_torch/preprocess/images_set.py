"""Assembly of THINGS ``images_set/`` (copy of
``eeg_image_decode_tpu/preprocess/images_set.py``; host file work only).

Rebuilds ``MEG-preprocessing/pre_possess.ipynb`` cells 31-38: given the THINGS
metadata CSVs (``image_paths.csv`` — one relative image path per event id;
``image_concept_index.csv`` — one concept index per image), copy each image
into ``images_set/{training,test}_images`` depending on which split its event
id landed in, renaming the concept folder to ``{index:05d}_{concept}`` so
folders sort by concept id (the naming the EEG datasets rely on).
"""

from __future__ import annotations

import os
import shutil
from collections.abc import Iterable


def concept_folder_name(concept_index: int, original: str) -> str:
    return f"{concept_index:05d}_{original}"


def build_images_set(
    image_paths: list[str],
    concept_indices: list[int],
    train_event_ids: Iterable[int],
    test_event_ids: Iterable[int],
    *,
    origin_dir: str,
    out_dir: str,
    copy_fn=shutil.copy,
) -> dict[str, int]:
    """Event id of image ``i`` is ``i+1`` (the notebook's 1-based convention).

    Returns counts per split. ``copy_fn`` is injectable for tests.
    """
    train_ids = set(int(x) for x in train_event_ids)
    test_ids = set(int(x) for x in test_event_ids)
    counts = {"training": 0, "test": 0, "skipped": 0}
    for index, rel_path in enumerate(image_paths):
        event_id = index + 1
        concept_index = int(concept_indices[index])
        parts = rel_path.split("/")
        if len(parts) > 2:
            parts[1] = concept_folder_name(concept_index, parts[1])
        dest_rel = "/".join(parts)

        if event_id in train_ids:
            split = "training"
        elif event_id in test_ids:
            split = "test"
        else:
            counts["skipped"] += 1
            continue
        dest = os.path.join(out_dir, f"{split}_images", dest_rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        copy_fn(os.path.join(origin_dir, rel_path), dest)
        counts[split] += 1
    return counts


def load_things_metadata(
    image_paths_csv: str, concept_index_csv: str
) -> tuple[list[str], list[int]]:
    """Read the two header-less THINGS metadata CSVs."""
    import csv

    with open(image_paths_csv) as f:
        paths = [row[0] for row in csv.reader(f) if row]
    with open(concept_index_csv) as f:
        concepts = [int(row[0]) for row in csv.reader(f) if row]
    return paths, concepts
