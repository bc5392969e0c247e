"""The YOLOv2 output layer and host-side non-maximum suppression
(counterpart of ``deeplearning4j_tpu/nn/layers/objdetect.py``).

Predictions and labels are NHWC, [B, H, W, A * (5 + C)] over an H x W
grid with A anchors, each anchor's slice (x, y, w, h, confidence,
classes); the label's confidence marks the responsible anchor cell.
The activation is sigmoid on xy and confidence, exp(wh) times the
anchor, softmax over classes; the loss is YOLO's sum of squares with
``lambda_coord`` and ``lambda_noobj``, taking the square root of
``torch.maximum(wh, 1e-8)`` (each side of a tie half the gradient, as
``jnp.maximum``). NMS runs on numpy arrays on the host, the port's own
copy of JAX's function.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import global_batch as G
from . import Layer, register


@register
class Yolo2OutputLayer(Layer):
    """YOLOv2 detection head, no params: the YOLO activation in
    ``apply`` and the YOLO loss in ``compute_loss``, on the incoming
    map."""

    kind = "yolo2output"

    def __init__(self, anchors: Sequence[Sequence[float]] = ((1.0, 1.0),),
                 lambda_coord: float = 5.0, lambda_noobj: float = 0.5, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.anchors = tuple(tuple(float(v) for v in a) for a in anchors)
        self.lambda_coord = float(lambda_coord)
        self.lambda_noobj = float(lambda_noobj)
        self._anchor_cache = {}

    @property
    def n_anchors(self):
        return len(self.anchors)

    def _split(self, x):
        """[B, H, W, A * (5 + C)] -> xy, wh, conf, cls, each
        [B, H, W, A, .]."""
        B, H, W, F = x.shape
        A = self.n_anchors
        z = x.reshape(B, H, W, A, F // A)
        return z[..., 0:2], z[..., 2:4], z[..., 4:5], z[..., 5:]

    def _anchors(self, x):
        """The [A, 2] anchors in ``x``'s dtype on its device, made once
        (a copy from the host cannot run inside a CUDA graph capture;
        the engine's eager call before it makes them)."""
        key = (x.device, x.dtype)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.tensor(
                self.anchors, dtype=x.dtype, device=x.device)
        return self._anchor_cache[key]

    def activate_detection(self, x):
        xy, wh, conf, cls = self._split(x)
        return torch.cat([torch.sigmoid(xy), torch.exp(wh) * self._anchors(x),
                          torch.sigmoid(conf), torch.softmax(cls, dim=-1)],
                         dim=-1)

    def apply(self, params, x, state, train, rng):
        return self.activate_detection(x).reshape(x.shape), state

    def compute_loss(self, params, x, labels, mask=None, train: bool = False,
                     rng=None):
        pred_xy, pred_wh, pred_conf, pred_cls = self._split(x)
        lab_xy, lab_wh, lab_conf, lab_cls = self._split(labels)
        p_xy = torch.sigmoid(pred_xy)
        p_wh = torch.exp(pred_wh) * self._anchors(x)
        p_conf = torch.sigmoid(pred_conf)
        p_cls = torch.softmax(pred_cls, dim=-1)
        obj = lab_conf
        noobj = 1.0 - obj
        floor = torch.full_like(p_wh, 1e-8)
        loss_xy = torch.sum(obj * torch.square(p_xy - lab_xy))
        loss_wh = torch.sum(obj * torch.square(
            torch.sqrt(torch.maximum(p_wh, floor))
            - torch.sqrt(torch.maximum(lab_wh, floor))))
        loss_obj = torch.sum(obj * torch.square(p_conf - 1.0))
        loss_noobj = torch.sum(noobj * torch.square(p_conf))
        loss_cls = torch.sum(obj * torch.square(p_cls - lab_cls))
        return (self.lambda_coord * (loss_xy + loss_wh) + loss_obj
                + self.lambda_noobj * loss_noobj
                + loss_cls) / G.rows(x.shape[0])

    def _extra_json(self):
        return {"anchors": [list(a) for a in self.anchors],
                "lambda_coord": self.lambda_coord,
                "lambda_noobj": self.lambda_noobj}


def non_max_suppression(boxes: np.ndarray, scores: np.ndarray,
                        iou_threshold: float = 0.45,
                        score_threshold: float = 0.5):
    """Greedy NMS over [N, 4] (x, y, w, h) boxes on the host: the boxes
    scoring at least ``score_threshold``, best first, each dropping the
    rest that overlap it by more than ``iou_threshold``. Returns the
    kept boxes and scores."""
    keep_mask = scores >= score_threshold
    boxes, scores = boxes[keep_mask], scores[keep_mask]
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        order = rest[_iou_xywh(boxes[i], boxes[rest]) <= iou_threshold]
    return boxes[keep], scores[keep]


def _iou_xywh(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    """Intersection over union of one (x, y, w, h) box with each of
    ``others``."""
    bx1, by1 = box[0] - box[2] / 2, box[1] - box[3] / 2
    bx2, by2 = box[0] + box[2] / 2, box[1] + box[3] / 2
    ox1 = others[:, 0] - others[:, 2] / 2
    oy1 = others[:, 1] - others[:, 3] / 2
    ox2 = others[:, 0] + others[:, 2] / 2
    oy2 = others[:, 1] + others[:, 3] / 2
    ix = np.maximum(0, np.minimum(bx2, ox2) - np.maximum(bx1, ox1))
    iy = np.maximum(0, np.minimum(by2, oy2) - np.maximum(by1, oy1))
    inter = ix * iy
    union = box[2] * box[3] + others[:, 2] * others[:, 3] - inter
    return inter / np.maximum(union, 1e-9)
