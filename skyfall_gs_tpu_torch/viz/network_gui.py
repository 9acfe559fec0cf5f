"""Live viewer bridge: the SIBR remote-viewer TCP protocol.

Port of ``skyfall_gs_tpu/viz/network_gui.py`` with the wire protocol
unchanged, so existing SIBR remote viewers connect: a non-blocking
listener polled each training iteration; the viewer sends a 4-byte
little-endian length, then JSON with the resolution, FoV, near / far, the
row-major transposed view and view-projection matrices (with the SIBR y/z
sign flips) and the training toggles; the trainer replies with raw RGB
``uint8`` bytes, then a length-prefixed verification string.

The camera becomes the port's column-vector ``Camera`` on the caller's
device.  One deliberate difference: ``poll`` drops the viewer only on the
viewer's own failures (a socket error, a short read, a malformed message)
and lets anything ``render_fn`` raises propagate, where the JAX package
drops the viewer on every exception.
"""

from __future__ import annotations

import json
import math
import socket
from typing import Optional, Tuple

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.camera import Camera


class ViewerMessageError(ValueError):
    """A viewer message that is not a valid request."""


# The failures that end a viewer connection without ending training.
# ``ConnectionError`` (a closed socket, a short read) is an ``OSError``;
# ``json.JSONDecodeError`` is a ``ValueError`` like ``ViewerMessageError``.
VIEWER_ERRORS = (OSError, json.JSONDecodeError, UnicodeDecodeError, ViewerMessageError)


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> None:
        if self.conn is not None:
            return
        try:
            self.conn, addr = self.listener.accept()
            self.conn.settimeout(None)
            print(f"viewer connected from {addr}")
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read_message(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self, device="cpu") -> Tuple[Optional[Camera], dict]:
        """Read one viewer request: (the camera on ``device``, or None for a
        zero resolution; the toggles)."""
        msg = self._read_message()
        try:
            width, height = int(msg["resolution_x"]), int(msg["resolution_y"])
            toggles = {
                "train": bool(msg.get("train", True)),
                "keep_alive": bool(msg.get("keep_alive", False)),
                "scaling_modifier": float(msg.get("scaling_modifier", 1.0)),
            }
            if width == 0 or height == 0:
                return None, toggles
            fovy, fovx = float(msg["fov_y"]), float(msg["fov_x"])
            znear, zfar = float(msg["z_near"]), float(msg["z_far"])
            # SIBR sends row-major transposed matrices with y/z column flips.
            wv_t = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
            fp_t = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        except (KeyError, TypeError, ValueError) as e:
            raise ViewerMessageError(f"malformed viewer request: {e!r}") from e
        wv_t[:, 1] *= -1
        wv_t[:, 2] *= -1
        fp_t[:, 1] *= -1
        # Transpose back to the column-vector convention.
        world_view = np.ascontiguousarray(wv_t.T)
        full_proj = np.ascontiguousarray(fp_t.T)
        c2w = np.linalg.inv(world_view.astype(np.float64))

        def scalar(v):
            return torch.tensor(np.float32(v), device=device)

        cam = Camera(
            world_view=torch.from_numpy(world_view).to(device),
            full_proj=torch.from_numpy(full_proj).to(device),
            cam_center=torch.from_numpy(c2w[:3, 3].astype(np.float32)).to(device),
            tan_fovx=scalar(math.tan(fovx / 2)),
            tan_fovy=scalar(math.tan(fovy / 2)),
            focal_x=scalar(width / (2 * math.tan(fovx / 2))),
            focal_y=scalar(height / (2 * math.tan(fovy / 2))),
            cx=scalar(0.0),
            cy=scalar(0.0),
            uid=0,
            znear=znear,
            zfar=zfar,
            width=width,
            height=height,
        )
        return cam, toggles

    def send(self, image, verify: str) -> None:
        """Send an (H, W, 3) frame in [0, 1] (a tensor on any device, an
        array, or None) and the verify string.  A tensor is quantized on its
        device; its ``uint8`` bytes are the only copy to the host."""
        if image is not None:
            if isinstance(image, torch.Tensor):
                data = (torch.clamp(image, 0, 1) * 255).to(torch.uint8).cpu().numpy()
            else:
                data = (np.clip(image, 0, 1) * 255).astype(np.uint8)
            self.conn.sendall(data.tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def drop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def poll(self, render_fn, source_path: str, training_active: bool,
             device="cpu") -> bool:
        """One training-loop poll (reference train.py:143-156 semantics).

        ``render_fn(camera, scaling_modifier)`` -> (H, W, 3) image or None;
        the camera lies on ``device``.  Serves requests until the viewer
        lets training go on; a viewer failure drops the connection, and an
        exception from ``render_fn`` propagates.  Returns True.
        """
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, toggles = self.receive(device)
            except VIEWER_ERRORS:
                self.drop()
                break
            image = render_fn(cam, toggles["scaling_modifier"]) if cam is not None else None
            try:
                self.send(image, source_path)
            except OSError:
                self.drop()
                break
            if toggles["train"] and (training_active or not toggles["keep_alive"]):
                break
        return True
