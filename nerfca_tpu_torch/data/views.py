"""Sparse-view experiment setup: train/test viewpoint selection.

Reference parity: ``preprocess/general_helpers.py:69-172``
(``setup_experiment_type``):
  - clinical test views are preset LAO/RAO-CRA/CAU angle pairs;
  - train views come from a (theta, phi) grid over ``+/- limited_range`` at
    ``step_size``, dropping any grid angle within 15 degrees (L1) of a test
    view;
  - if exactly 4 grid angles survive, the 4-view clinical preset replaces
    them; alternatively ``numb_angles`` in {2, 3, 4} picks a preset directly;
  - every cardiac phase in the requested time range shares the same
    viewpoints, and the test views are attached to every phase.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

# Preset clinical validation views [theta, phi] (LAO=+theta, CRA=+phi).
CLINICAL_TEST_ANGLES = np.array([[-5, 40], [-5, -40], [90, 0], [-30, 0]])

FOUR_VIEW_PRESET = np.array([[-30, 30], [-30, -30], [60, -30], [60, 30]])
THREE_VIEW_PRESET = np.array([[-30, -30], [60, -30], [60, 30]])
TWO_VIEW_PRESET = np.array([[-30, -30], [60, 30]])

CLOSE_THRESH_DEG = 15.0


def grid_angles(limited_range: float, step_size: float) -> np.ndarray:
    """All (theta, phi) combinations over the symmetric limited range."""
    thetas = np.arange(-limited_range, limited_range + 1, step_size)
    phis = np.arange(-limited_range, limited_range + 1, step_size)
    return (
        np.array(np.meshgrid(thetas, phis, indexing="ij")).reshape(2, -1).T
    )


def drop_near_test_views(angles: np.ndarray, test_angles: np.ndarray) -> np.ndarray:
    """Remove train angles within 15 degrees L1 of any test view."""
    if len(angles) == 0:
        return angles
    d = np.abs(angles[:, None, :] - test_angles[None, :, :]).sum(-1)
    keep = (d > CLOSE_THRESH_DEG).all(axis=1)
    return angles[keep]


def select_views(
    limited_range: float,
    step_size: float,
    numb_angles: Optional[int] = None,
    time_range_start: int = 0,
    time_range_end: int = 10,
    limited_range_test: Optional[float] = None,
    step_size_test: Optional[float] = None,
    selection_view: Optional[tuple] = None,
) -> list[dict]:
    """Build the per-phase viewpoint list (the ``phase_volume_lst`` shape).

    Returns one dict per cardiac phase with keys ``hrt_phase`` (decimal),
    ``resp_phase``, ``train_viewpoints``, ``test_viewpoints``.

    ``selection_view``: optional (theta, phi) prepended to the test views as
    a dedicated model-selection view. The trainer's in-loop metric (and
    therefore checkpoint-best retention) uses the FIRST test frame
    (``run_composite.py:74-76``), so putting a dedicated view there — and
    excluding it from ``evaluate.json`` (see ``dataset.build_dataset``) —
    keeps model selection disjoint from the reported held-out set."""
    if limited_range_test is not None and step_size_test is not None:
        t = np.arange(-limited_range_test, limited_range_test + 1, step_size_test)
        test_angles = np.array(np.meshgrid(t, t, indexing="ij")).reshape(2, -1).T
        test_angles = np.insert(test_angles, 0, [0, -90], axis=0)
    else:
        test_angles = CLINICAL_TEST_ANGLES

    if step_size <= limited_range:
        angles = drop_near_test_views(grid_angles(limited_range, step_size), test_angles)
        # exactly-4 fallback to the clinical sparse preset
        if angles.shape[0] == 4:
            angles = FOUR_VIEW_PRESET
    elif numb_angles is not None:
        presets = {4: FOUR_VIEW_PRESET, 3: THREE_VIEW_PRESET, 2: TWO_VIEW_PRESET}
        if numb_angles not in presets:
            raise ValueError(f"numb_angles must be 2, 3, or 4; got {numb_angles}")
        angles = presets[numb_angles]
    else:
        raise ValueError(
            "step_size > limited_range requires numb_angles in {2, 3, 4}"
        )

    if selection_view is not None:
        sels = np.asarray(selection_view, dtype=float)
        if sels.ndim == 1:
            sels = sels[None, :]
        # drop any existing test row matching a selection view BEFORE
        # prepending them: a duplicated angle would render twice in
        # test-*.json AND be filtered out of evaluate.json entirely by
        # build_dataset's selection-angle exclusion (every copy matches)
        keep = ~np.any(
            np.all(test_angles[:, None, :] == sels[None, :, :], axis=-1),
            axis=1,
        )
        test_angles = np.concatenate([sels, test_angles[keep]], axis=0)

    phases = np.arange(time_range_start, time_range_end) / 10
    return [
        {
            "hrt_phase": float(p),
            "resp_phase": 0,
            "train_viewpoints": angles,
            "test_viewpoints": test_angles,
            **(
                {"selection_viewpoint": sels[0].tolist(),
                 "selection_viewpoints": sels.tolist()}
                if selection_view is not None
                else {}
            ),
        }
        for p in phases
    ]


def load_experiment_views(path: str) -> list[dict]:
    """Load a curated experiment json: the hand-written per-phase
    view/phase list the reference reads for ``use_experiment_name``
    (``preprocess/general_helpers.py:70-78`` — the file IS the
    ``phase_volume_lst``). Viewpoint lists become float arrays; missing
    ``resp_phase`` defaults to 0 and missing ``test_viewpoints`` to empty."""
    with open(path) as f:
        phase_list = json.load(f)
    out = []
    for obj in phase_list:
        row = dict(obj)
        row["hrt_phase"] = float(obj["hrt_phase"])
        row.setdefault("resp_phase", 0)
        row["train_viewpoints"] = np.asarray(obj["train_viewpoints"], dtype=float).reshape(-1, 2)
        row["test_viewpoints"] = np.asarray(obj.get("test_viewpoints", []),
                                            dtype=float).reshape(-1, 2)
        out.append(row)
    return out
