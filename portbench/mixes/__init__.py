"""The runners of the traffic mixes, one module to a kind: a workload
file's ``kind`` names ``portbench/mixes/<kind>.py``, found by that name,
whose ``drive`` runs one cell (inputs and weights from the seed, handed to
the program; warm-up; the window or a traced window; then the timed path's
output against the plain reference) and whose ``readings`` gives what the
limits of ``correct`` are set from (``control.py``). Here: what the kinds
share.

The program is the port, ``nerfca_tpu_torch``: its step builders and chunk
runner (``train/step.py``, ``train/trainer.py``), its renderer
(``train/evaluation.py``) and its kernels (``ops/cuda/``). What it makes is
read only to judge it.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from portbench import inputs


def runner(kind: str):
    """The module of a traffic kind: ``portbench/mixes/<kind>.py``."""
    return importlib.import_module(f"portbench.mixes.{kind}")


def config_fields(cfg: dict) -> dict:
    """The configuration's fields as plain dicts: the static field, and
    the temporal one for the composite method."""
    names = ["static"] + (["temp"] if cfg["method"] == "composite" else [])
    out = {}
    for n in names:
        p = "static_" if n == "static" else "temp_"
        basis = cfg[p + "pos_enc_basis"]
        out[n] = {"num_early_layers": cfg[p + "num_early_layers"],
                  "num_filters": cfg[p + "num_filters"], "pos_enc": cfg[p + "pos_enc"],
                  "pos_enc_basis": basis, "encoded_features": 3 + 6 * basis,
                  "pos_enc_window_start": cfg[p + "pos_enc_window_start"],
                  "pos_enc_window_decay_steps": cfg[p + "pos_enc_window_decay_steps"],
                  "use_time_latents": n == "temp" and cfg["use_time_latents"],
                  "num_time_dim": cfg["num_time_dim"]}
        if out[n]["pos_enc"] != "free_windowed" or cfg[p + "num_late_layers"] != 0:
            raise ValueError("the reference covers free_windowed fields without late layers")
    return out


def resolved(cfg: dict, traffic: dict) -> dict:
    """The configuration with what the traffic adds and what follows from
    both: the fields, the high-variance share, the jitter's angle."""
    cfg = dict(cfg)
    cfg["fields"] = config_fields(cfg)
    cfg["nb_var_rays"] = int(cfg["var_sample_perc"] / 100.0 * cfg["img_sample_size"])
    acq = inputs.geometry.acquisition(cfg["data_size"])  # the jitter in pixel angles
    cfg["ray_jitter"] = traffic.get("ray_jitter_perc", 0.0) * acq["pitch"] / acq["DSD"]
    return cfg


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def build_kernels(device) -> None:
    if device.type == "cuda":
        from nerfca_tpu_torch.ops.cuda import build

        build.build()


def program_fields(cfg: dict) -> dict:
    from nerfca_tpu_torch.models.fields import FieldConfig

    out = {}
    for name, f in cfg["fields"].items():
        out[name] = FieldConfig(
            num_early_layers=f["num_early_layers"], num_late_layers=0,
            num_filters=f["num_filters"], pos_enc=f["pos_enc"], pos_enc_basis=f["pos_enc_basis"],
            pos_enc_window_start=f["pos_enc_window_start"],
            pos_enc_window_decay_steps=f["pos_enc_window_decay_steps"],
            use_time_latents=f["use_time_latents"], num_time_dim=f["num_time_dim"])
    return out


def program_hparams(cfg: dict):
    from nerfca_tpu_torch.train.step import CompositeHParams, StaticHParams

    if cfg["method"] == "static":
        return StaticHParams(
            img_sample_size=cfg["img_sample_size"], nb_var_rays=cfg["nb_var_rays"],
            depth_samples_coarse=cfg["depth_samples_per_ray_coarse"],
            output_activation=cfg["output_activation"],
            occl_weight_start=cfg["occl_weight_start"], occl_reg_perc=cfg["occl_reg_perc"],
            compute_dtype=cfg["compute_dtype"], use_pallas=cfg["use_pallas"])
    keys = [f.name for f in dataclasses.fields(CompositeHParams)]
    kw = {k: cfg[k] for k in keys if k in cfg}
    kw.update(nb_var_rays=cfg["nb_var_rays"], ray_jitter=cfg["ray_jitter"],
              depth_samples_coarse=cfg["depth_samples_per_ray_coarse"],
              depth_samples_fine=cfg["depth_samples_per_ray_fine"])
    return CompositeHParams(**kw)


def program_hull(hull):
    from nerfca_tpu_torch.ops.hull import MotionHull

    return None if hull is None else MotionHull(hull["grid"], hull["d_voxel"], hull["off"])
