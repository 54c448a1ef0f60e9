"""Homogeneous rotation/translation primitives and C-arm pose construction.

Port of ``nerfca_tpu/geometry/rotations.py`` (numpy, unchanged). Poses are
built host-side once per viewpoint (they are tiny 4x4 matrices); everything
downstream of them is batched torch. Angles are in degrees at the
public API surface, matching clinical LAO/RAO (theta) and CRA/CAU (phi)
conventions.

Reference parity:
  - rotation primitives: ``train/proj_helpers.py:5-32``
  - C-arm ("tigre") convention R = Rz(-theta) Rz(pi/2) Rx(phi) Rx(-pi/2):
    ``train/proj_helpers.py:50-57``. The preprocess variant
    (``preprocess/proj_helpers.py:33-46``) uses Rz(+theta) and is always
    called with ``-theta`` (``preprocess/datatoray.py:105``), so the two
    stacks agree; this module implements the single shared convention.
  - "roadmap" convention R = inv(Rz(larm) Rx(theta) Ry(phi)):
    ``train/proj_helpers.py:34-47``.
"""

from __future__ import annotations

import numpy as np


def rot_x(angle_rad: float) -> np.ndarray:
    """4x4 homogeneous rotation about the x axis."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rot_y(angle_rad: float) -> np.ndarray:
    """4x4 homogeneous rotation about the y axis."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rot_z(angle_rad: float) -> np.ndarray:
    """4x4 homogeneous rotation about the z axis."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def translation(vec) -> np.ndarray:
    """4x4 homogeneous translation by ``vec[:3]``."""
    m = np.eye(4)
    m[:3, 3] = np.asarray(vec, dtype=np.float64)[:3]
    return m


def carm_rotation(theta_deg: float, phi_deg: float, larm_deg: float = 0.0) -> np.ndarray:
    """C-arm gantry rotation for cone-beam acquisition.

    ``theta`` is the LAO(+)/RAO(-) angle, ``phi`` the CRA(+)/CAU(-) angle.
    ``larm`` is accepted for interface parity but ignored, exactly as in the
    reference's tigre path (``train/proj_helpers.py:50-57`` never uses it).
    """
    del larm_deg
    return (
        rot_z(-np.deg2rad(theta_deg))
        @ rot_z(np.pi / 2)
        @ rot_x(np.deg2rad(phi_deg))
        @ rot_x(-np.pi / 2)
    )


def carm_source_matrix(
    theta_deg: float, phi_deg: float, larm_deg: float = 0.0, dso: float = 1.0
) -> np.ndarray:
    """World-from-source pose: rotation applied to the source translation.

    The X-ray source sits at ``[0, 0, -DSO]`` in the unrotated frame
    (``train/proj_helpers.py:65-69``); the returned 4x4 carries the rotated
    source position in its translation column.
    """
    return carm_rotation(theta_deg, phi_deg, larm_deg) @ translation([0.0, 0.0, -dso])


def roadmap_rotation(theta_deg: float, phi_deg: float, larm_deg: float = 0.0) -> np.ndarray:
    """Alternative 'roadmap run' pose convention (``train/proj_helpers.py:34-38``)."""
    m = rot_z(np.deg2rad(larm_deg)) @ rot_x(np.deg2rad(theta_deg)) @ rot_y(np.deg2rad(phi_deg))
    return np.linalg.inv(m)


def roadmap_source_matrix(source_pt, theta_deg: float, phi_deg: float, larm_deg: float = 0.0,
                          table_translation=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Roadmap pose with source and table translations
    (``train/proj_helpers.py:40-47``)."""
    m = roadmap_rotation(theta_deg, phi_deg, larm_deg) @ translation(source_pt)
    return translation(list(table_translation)) @ m
