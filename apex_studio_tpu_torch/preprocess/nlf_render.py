"""Depth-ordered limb-capsule renderer for the dwpose_nlf preprocessor (a
copy of ``apex_studio_tpu/preprocess/nlf_render.py``: host numpy, no JAX).

Behavioral counterpart of the reference's software ray-tracer
(``src/preprocess/dwpose_nlf/render_helpers.py:263 render_whole``): each limb
of the NLF 3D skeleton is a capsule (cylinder + end spheres) in camera space
(mm); every pixel's ray is intersected analytically against the capsules in a
conservative screen-space ROI, the nearest hit wins the z-buffer, and shading
is the reference's diffuse + Blinn-Phong + global depth fade. Output is RGBA
uint8 per frame.

The COCO-17 conversion and per-limb color/sequence tables mirror
``render_helpers.py:33 process_data_to_COCO_format`` and the tables in
``dwpose_nlf/__init__.py:251-346``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# SMPL-24 -> COCO-ish 18-slot mapping (render_helpers.py:44)
_SMPL_TO_COCO = {15: 0, 12: 1, 17: 2, 16: 5, 19: 3, 18: 6, 21: 4, 20: 7,
                 2: 8, 1: 11, 5: 9, 4: 12, 8: 10, 7: 13}

# limb endpoints into the COCO-18 slots (dwpose_nlf/__init__.py:296) and the
# near-to-far draw order (:324)
LIMB_SEQ = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
            (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
            (0, 15), (15, 17)]
DRAW_SEQ = [0, 2, 3, 1, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

_RGB255 = [(255, 0, 0), (0, 255, 255), (255, 85, 0), (255, 170, 0),
           (0, 170, 255), (0, 85, 255), (180, 255, 0), (0, 255, 0),
           (0, 255, 85), (0, 0, 255), (85, 0, 255), (170, 0, 255),
           (150, 150, 150), (255, 0, 170), (50, 0, 255), (255, 0, 170),
           (50, 0, 255)]
# reference color transform: c/300 + 0.15 with alpha 0.8 (__init__.py:346)
COLORS = [[c / 300 + 0.15 for c in rgb] + [0.8] for rgb in _RGB255]


def smpl_to_coco(joints: np.ndarray) -> np.ndarray:
    """(24, D) SMPL joints -> (18, D) COCO-slot array (unmapped slots zero)."""
    out = np.zeros((18, joints.shape[1]), dtype=joints.dtype)
    for src, dst in _SMPL_TO_COCO.items():
        out[dst] = joints[src]
    return out


def pose_cylinder_specs(people: Sequence[np.ndarray]
                        ) -> List[Tuple[np.ndarray, np.ndarray, list]]:
    """Per-frame capsule list from per-person (24,3) mm joints
    (render_helpers.py:68 get_single_pose_cylinder_specs)."""
    specs = []
    for joints in people:
        coco = smpl_to_coco(np.asarray(joints))
        for li in DRAW_SEQ:
            a, b = LIMB_SEQ[li]
            if np.sum(coco[a]) == 0 or np.sum(coco[b]) == 0:
                continue
            specs.append((coco[a], coco[b], COLORS[li]))
    return specs


def render_capsule_frames(specs_list, H: int, W: int, fx: float, fy: float,
                          cx: float, cy: float,
                          radius: float = 21.5) -> List[np.ndarray]:
    """Ray-trace capsule specs per frame -> RGBA uint8 frames
    (render_helpers.py:263 render_whole)."""
    if len(specs_list) == 0:
        return []

    zs = [float(p[2]) for specs in specs_list for seg in specs
          for p in seg[:2] if len(p) >= 3]
    if not zs:
        return [np.zeros((H, W, 4), np.uint8) for _ in specs_list]

    znear = 0.1
    depth_near = max(min(zs), znear)
    depth_far = min(max(zs) + 6000.0, 20000.0)
    if depth_far <= depth_near + 1e-6:
        depth_far = depth_near + 1.0

    # camera rays (identity rotation pinhole)
    gx = (np.arange(W, dtype=np.float32) - cx) / fx
    gy = (np.arange(H, dtype=np.float32) - cy) / fy
    rd = np.stack(np.broadcast_arrays(gx[None, :], gy[:, None],
                                      np.float32(1.0)), axis=-1)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    # Blinn-Phong half vector for light_dir (0,0,1): normalize(-rd+(0,0,-1))
    half = -rd.copy()
    half[..., 2] -= 1.0
    half /= np.linalg.norm(half, axis=-1, keepdims=True) + 1e-12

    pad_base = max(3, int(round(0.08 * max(H, W))))

    def _roi(a, b):
        za, zb = max(a[2], znear), max(b[2], znear)
        ua, va = fx * a[0] / za + cx, fy * a[1] / za + cy
        ub, vb = fx * b[0] / zb + cx, fy * b[1] / zb + cy
        zm = 0.5 * (za + zb)
        r_px = radius * (0.5 * (fx + fy)) / max(zm, znear)
        pad = int(np.clip(np.ceil(r_px) + pad_base, 4, max(H, W)))
        return (max(0, int(np.floor(min(ua, ub))) - pad),
                min(W, int(np.ceil(max(ua, ub))) + pad),
                max(0, int(np.floor(min(va, vb))) - pad),
                min(H, int(np.ceil(max(va, vb))) + pad))

    def _sphere_t(center, rays, r):
        b = 2.0 * np.einsum("hwc,c->hw", rays, -center)
        c = float(center @ center) - r * r
        disc = b * b - 4.0 * c
        t = np.where(disc >= 0, (-b - np.sqrt(np.maximum(disc, 0))) * 0.5,
                     np.inf)
        return np.where(t >= znear, t, np.inf).astype(np.float32)

    frames = []
    for specs in specs_list:
        if len(specs) == 0:
            frames.append(np.zeros((H, W, 4), np.uint8))
            continue
        zbuf = np.full((H, W), np.inf, np.float32)
        rgb = np.zeros((H, W, 3), np.float32)
        alpha = np.zeros((H, W), np.float32)

        for a, b, c in specs:
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            col = np.asarray(c, np.float32).reshape(-1)
            if col.shape[0] == 3:
                col = np.append(col, 1.0)
            x0, x1, y0, y1 = _roi(a, b)
            if x1 <= x0 or y1 <= y0:
                continue
            rays = rd[y0:y1, x0:x1]

            # nearest valid hit among: sphere(a), sphere(b), finite cylinder
            t_hit = np.minimum(_sphere_t(a, rays, radius),
                               _sphere_t(b, rays, radius))
            ba = b - a
            seg_len = float(np.linalg.norm(ba))
            axis = (ba / seg_len) if seg_len >= 1e-8 else np.zeros(3,
                                                                   np.float32)
            if seg_len >= 1e-8:
                d_dot = rays @ axis
                delta_dot = float(-a @ axis)
                dp = rays - d_dot[..., None] * axis
                dd = -a - delta_dot * axis
                qa = np.einsum("hwc,hwc->hw", dp, dp)
                qb = 2.0 * (dp @ dd)
                qc = float(dd @ dd) - radius * radius
                disc = qb * qb - 4.0 * qa * qc
                ok = (disc >= 0) & (qa > 1e-12)
                sd = np.sqrt(np.maximum(disc, 0))
                inv2a = 0.5 / np.where(qa > 1e-12, qa, 1.0)
                for t_c in ((-qb - sd) * inv2a, (-qb + sd) * inv2a):
                    along = delta_dot + d_dot * t_c
                    good = ok & (t_c >= znear) & (along >= 0) & (
                        along <= seg_len)
                    t_hit = np.where(good & (t_c < t_hit),
                                     t_c.astype(np.float32), t_hit)

            z_roi = zbuf[y0:y1, x0:x1]
            update = t_hit < z_roi
            if not np.any(update):
                continue

            # shading at hit point
            t_use = np.where(update, t_hit, 0.0).astype(np.float32)
            p = rays * t_use[..., None]
            if seg_len > 1e-8:
                along = np.clip((p - a) @ axis, 0.0, seg_len)
                q = a + along[..., None] * axis
            else:
                q = np.broadcast_to(a, p.shape)
            n = p - q
            n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
            diffuse = 0.3 + 0.7 * np.maximum(-n[..., 2], 0.0)
            ndh = np.maximum(np.einsum("hwc,hwc->hw", n, half[y0:y1, x0:x1]),
                             0.0)
            spec = ndh ** 32
            depth_f = np.clip(1.0 - (p[..., 2] - depth_near)
                              / (depth_far - znear), 0.0, 1.0)
            shade = (col[:3][None, None] * (diffuse * depth_f)[..., None]
                     + (0.5 * spec * depth_f)[..., None])

            z_roi[update] = t_hit[update]
            roi_rgb = rgb[y0:y1, x0:x1]
            roi_rgb[update] = shade[update]
            alpha[y0:y1, x0:x1][update] = float(np.clip(col[3], 0.0, 1.0))

        out = np.zeros((H, W, 4), np.uint8)
        out[..., :3] = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        out[..., 3] = (np.clip(alpha, 0, 1) * 255).astype(np.uint8)
        frames.append(out)
    return frames
