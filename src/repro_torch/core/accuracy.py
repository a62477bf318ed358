"""Accuracy models A_n(s) (paper §III-C).

Port of `repro/core/accuracy.py`. The paper assumes A(s_1..s_N) =
sum_n A_n(s_n) with each A_n concave and nondecreasing in the frame
resolution s_n, and evaluates a *linear* A_n whose endpoints come from the
YOLO accuracy-vs-resolution measurements of the paper's Fig. 7 (mAP at
160/320/480/640 px). Logarithmic and power-law fits are kept as well.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np
import torch

Tensor = torch.Tensor

# mAP operating points in the YOLOv5m-on-COCO regime of the paper's Fig. 7
# (approximate values read off the figure; used as default accuracy data).
FIG7_RESOLUTIONS = (160.0, 320.0, 480.0, 640.0)
FIG7_MAP_YOLOV5M = (0.223, 0.321, 0.373, 0.402)
FIG7_MAP_YOLOV3TINY = (0.078, 0.130, 0.158, 0.170)


class AccuracyModel(Protocol):
    def value(self, s: Tensor) -> Tensor: ...
    def deriv(self, s: Tensor) -> Tensor: ...


@dataclasses.dataclass(frozen=True)
class LinearAccuracy:
    """A_n(s) = k * (s - s_lo) + a_lo  (paper Appendix B special case).

    The paper writes k_hat = (A_{s1} - A_{sM})/(sM - s1), which is negative
    for an increasing accuracy; that is a sign typo — the working slope is
    (A_{sM} - A_{s1})/(sM - s1), which is used here.
    """
    slope: float
    s_lo: float
    a_lo: float

    def value(self, s: Tensor) -> Tensor:
        return self.slope * (s - self.s_lo) + self.a_lo

    def deriv(self, s: Tensor) -> Tensor:
        return torch.full_like(s, self.slope)


@dataclasses.dataclass(frozen=True)
class LogAccuracy:
    """A_n(s) = a + b * log(s / s0); concave, nondecreasing for b >= 0."""
    a: float
    b: float
    s0: float

    def value(self, s: Tensor) -> Tensor:
        return self.a + self.b * torch.log(s / self.s0)

    def deriv(self, s: Tensor) -> Tensor:
        return self.b / s


@dataclasses.dataclass(frozen=True)
class PowerAccuracy:
    """A_n(s) = a - c * s^(-q); concave for c > 0, q > 0
    (A'' = -c q (q+1) s^(-q-2) < 0)."""
    a: float
    c: float
    q: float

    def value(self, s: Tensor) -> Tensor:
        return self.a - self.c * torch.pow(s, -self.q)

    def deriv(self, s: Tensor) -> Tensor:
        return self.c * self.q * torch.pow(s, -self.q - 1.0)


def linear_from_endpoints(s_lo: float, s_hi: float, a_lo: float,
                          a_hi: float) -> LinearAccuracy:
    return LinearAccuracy(slope=(a_hi - a_lo) / (s_hi - s_lo), s_lo=s_lo,
                          a_lo=a_lo)


def default_accuracy(resolutions=FIG7_RESOLUTIONS,
                     maps=FIG7_MAP_YOLOV5M) -> LinearAccuracy:
    """Paper-default linear model through the extreme Fig.-7 operating points."""
    return linear_from_endpoints(resolutions[0], resolutions[-1], maps[0],
                                 maps[-1])


def log_fit(resolutions=FIG7_RESOLUTIONS, maps=FIG7_MAP_YOLOV5M) -> LogAccuracy:
    """Least-squares log fit through the Fig.-7 points (a concave model)."""
    x = np.log(np.asarray(resolutions) / resolutions[0])
    y = np.asarray(maps)
    b, a = np.polyfit(x, y, 1)
    return LogAccuracy(a=float(a), b=float(b), s0=float(resolutions[0]))


def menu_of(acc, default=FIG7_RESOLUTIONS) -> tuple:
    """The resolution menu an accuracy model was fitted on: its `menu`
    attribute where it has one, else the paper's Fig. 7 grid."""
    menu = getattr(acc, "menu", None)
    return tuple(float(m) for m in menu) if menu else tuple(default)


def system_with_menu(sys, acc):
    """Re-key a `SystemParams` to the accuracy model's own resolution menu,
    so that rounding snaps onto the menu the model was fitted on. Models
    without an attached menu leave the system untouched."""
    menu = getattr(acc, "menu", None)
    if not menu:
        return sys
    menu = tuple(float(m) for m in menu)
    return sys if menu == tuple(sys.resolutions) \
        else sys.replace(resolutions=menu)
