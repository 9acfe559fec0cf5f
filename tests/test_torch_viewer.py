"""Port parity: the SIBR live viewer (viz/network_gui.py) and the Trainer's
viewer poll (train/loop.py ``_poll_gui``).

The wire tests of tests/test_infra.py rerun on the port; a seeded random
SIBR request gives the port's camera and the JAX package's the same
fields (rtol 1e-6: float32 matrices from one message, float64 focal
arithmetic on both sides) and the same 64 px render from each (1e-5
absolute, the forward kernel's parity bound of tests/test_torch_rasterize.py).
The Trainer's poll serves one frame per iteration, holds training while
the viewer pauses it, survives a disconnect, lets a render error out, and
never sends a frame that overflowed its binning capacity.

Every client socket has a timeout and every thread is joined with one, so
a hung exchange fails the test instead of the run.
"""

import json
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.core.camera import camera_from_c2w as jcamera_from_c2w
from skyfall_gs_tpu.core.camera import look_at_c2w
from skyfall_gs_tpu.model import gaussians as jg
from skyfall_gs_tpu.model.render import render as jrender
from skyfall_gs_tpu.viz.network_gui import NetworkGUI as JNetworkGUI
from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu_torch.io import synthetic as tsyn
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model.render import measure_bin_capacity
from skyfall_gs_tpu_torch.model.render import render as trender
from skyfall_gs_tpu_torch.train import loop as tloop
from skyfall_gs_tpu_torch.train.loop import Trainer
from skyfall_gs_tpu_torch.viz.network_gui import NetworkGUI
from tests.test_torch_core import jax_state_to_numpy

torch.set_num_threads(1)
TIMEOUT = 30.0
SIZE = 64


def sibr_request(world_view, full_proj, width, height, fovx, fovy, **toggles):
    """A viewer request in SIBR form: the matrices transposed to row-major
    with the sign flips the server undoes."""
    wv_t = np.asarray(world_view, np.float32).T.copy()
    wv_t[:, 1] *= -1
    wv_t[:, 2] *= -1
    fp_t = np.asarray(full_proj, np.float32).T.copy()
    fp_t[:, 1] *= -1
    msg = {"resolution_x": width, "resolution_y": height, "train": True,
           "keep_alive": False, "scaling_modifier": 1.0, "fov_x": fovx, "fov_y": fovy,
           "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
           "view_matrix": wv_t.flatten().tolist(),
           "view_projection_matrix": fp_t.flatten().tolist()}
    msg.update(toggles)
    return msg


def _recv_exact(c, n):
    buf = b""
    while len(buf) < n:
        chunk = c.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed")
        buf += chunk
    return buf


class Viewer:
    """A SIBR-style client thread: connects (retrying until the port
    listens), sends each request and reads its reply (``replies=False``:
    sends them and closes)."""

    def __init__(self, port, requests, replies=True):
        self.frames, self.verify, self.error = [], [], None
        self.thread = threading.Thread(target=self._run, args=(port, requests, replies),
                                       daemon=True)
        self.thread.start()

    def _run(self, port, requests, replies):
        try:
            deadline = time.monotonic() + TIMEOUT
            while True:
                try:
                    c = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
                    break
                except ConnectionRefusedError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.01)
            with c:
                for msg in requests:
                    raw = json.dumps(msg).encode()
                    c.sendall(len(raw).to_bytes(4, "little") + raw)
                    if not replies:
                        continue
                    n = msg["resolution_x"] * msg["resolution_y"] * 3
                    if n:
                        self.frames.append(_recv_exact(c, n))
                    vlen = int.from_bytes(_recv_exact(c, 4), "little")
                    self.verify.append(_recv_exact(c, vlen).decode())
        except Exception as e:   # reported by join()
            self.error = e

    def join(self):
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive(), "viewer thread did not finish"
        assert self.error is None, repr(self.error)


def connect(gui):
    for _ in range(int(TIMEOUT / 0.01)):
        gui.try_connect()
        if gui.conn is not None:
            return
        time.sleep(0.01)
    raise AssertionError("viewer did not connect")


def port_of(gui):
    return gui.listener.getsockname()[1]


def identity_request(**kw):
    eye = np.eye(4, dtype=np.float32)
    return sibr_request(eye, eye, 8, 8, 1.0, 1.0, **kw)


# ----------------------------------------------------------------------------
# The wire protocol (tests/test_infra.py:12-90 on the port)
# ----------------------------------------------------------------------------

def test_wire_protocol_roundtrip():
    gui = NetworkGUI("127.0.0.1", 0)
    viewer = Viewer(port_of(gui), [identity_request()])
    connect(gui)
    cam, toggles = gui.receive()
    assert cam is not None and cam.width == 8 and cam.height == 8
    assert toggles == {"train": True, "keep_alive": False, "scaling_modifier": 1.0}
    np.testing.assert_array_equal(cam.world_view.numpy(), np.eye(4))
    gui.send(torch.full((8, 8, 3), 0.5), "verify-string")
    viewer.join()
    assert viewer.frames[0] == bytes([127]) * 192
    assert viewer.verify == ["verify-string"]


def test_zero_resolution_returns_none():
    gui = NetworkGUI("127.0.0.1", 0)
    viewer = Viewer(port_of(gui), [{"resolution_x": 0, "resolution_y": 0}], replies=False)
    connect(gui)
    cam, toggles = gui.receive()
    assert cam is None and toggles["train"] is True
    viewer.join()


def test_random_request_matches_jax_camera_and_render():
    rng = np.random.default_rng(7)
    n = 300
    js = jg.create_from_points(rng.normal(0, 0.6, (n, 3)).astype(np.float32),
                               rng.uniform(0, 1, (n, 3)).astype(np.float32),
                               max_sh_degree=1, init_opacity=0.7, capacity=320)
    js = js.replace(aux=js.aux.replace(filter_3d=jnp.full(js.params.capacity, 0.01)))
    ts = tg.state_from_numpy(jax_state_to_numpy(js))
    eye = rng.normal(0, 1, 3)
    eye = 3.0 * eye / np.linalg.norm(eye)
    fovy = float(rng.uniform(0.6, 1.2))
    fovx = 2 * np.arctan(np.tan(fovy / 2) * 1.25)
    ref = jcamera_from_c2w(look_at_c2w(eye, rng.normal(0, 0.2, 3)), fovx, fovy, 80, SIZE)
    msg = sibr_request(np.asarray(ref.world_view), np.asarray(ref.full_proj), 80, SIZE,
                       fovx, fovy, scaling_modifier=float(rng.uniform(0.5, 1.0)))

    got = []
    for gui in (NetworkGUI("127.0.0.1", 0), JNetworkGUI("127.0.0.1", 0)):
        viewer = Viewer(port_of(gui), [msg], replies=False)
        connect(gui)
        got.append(gui.receive())
        viewer.join()
    (tcam, ttog), (jcam, jtog) = got
    assert ttog == jtog
    for k in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy", "focal_x",
              "focal_y", "cx", "cy"):
        np.testing.assert_allclose(getattr(tcam, k).numpy(), np.asarray(getattr(jcam, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
    assert (tcam.uid, tcam.znear, tcam.zfar, tcam.width, tcam.height) == \
        (int(jcam.uid), jcam.znear, jcam.zfar, jcam.width, jcam.height)
    np.testing.assert_allclose(tcam.world_view.numpy(), np.asarray(ref.world_view), atol=1e-7)

    mod = ttog["scaling_modifier"]
    jout = jrender(js, jcam, jnp.zeros(3), scaling_modifier=mod, testing=True, inference=True)
    tout = trender(ts, tcam, torch.zeros(3), scaling_modifier=mod, testing=True,
                   inference=True)
    assert int(tout.overflow) == int(jout.overflow) == 0
    assert float(tout.alpha.max()) > 0.5
    np.testing.assert_allclose(tout.color.numpy(), np.asarray(jout.color), rtol=0, atol=1e-5)


def test_poll_lets_a_render_error_propagate():
    gui = NetworkGUI("127.0.0.1", 0)
    viewer = Viewer(port_of(gui), [identity_request()], replies=False)
    connect(gui)

    def render_fn(camera, scaling_modifier):
        raise RuntimeError("kernel launch failed")

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        gui.poll(render_fn, "src", training_active=True)
    gui.drop()
    viewer.join()


@pytest.mark.parametrize("bad", [b"\x05\x00\x00\x00{oops", b"\x02\x00\x00\x00{}", b"\x09\x00"],
                         ids=["bad_json", "missing_keys", "short_read"])
def test_poll_drops_a_viewer_that_fails(bad):
    gui = NetworkGUI("127.0.0.1", 0)
    port = port_of(gui)

    def send_bad():
        with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as c:
            c.sendall(bad)

    t = threading.Thread(target=send_bad, daemon=True)
    t.start()
    connect(gui)
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert gui.poll(lambda c, s: pytest.fail("no frame to render"), "src", True) is True
    assert gui.conn is None


# ----------------------------------------------------------------------------
# The Trainer's poll
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return tsyn.make_city_scene(str(tmp_path_factory.mktemp("city")), n_views=4, size=SIZE,
                                n_points=300, n_test=1)


def make_trainer(scene, path, gui):
    opt = OptimizationConfig(iterations=6, densify_from_iter=10 ** 9, densify_until_iter=0,
                             position_lr_max_steps=6)
    return Trainer(ModelConfig(model_path=str(path)), opt, PipelineConfig(), scene, gui=gui)


def view_request(camera, **kw):
    return sibr_request(camera.world_view.numpy(), camera.full_proj.numpy(), camera.width,
                        camera.height, 2 * float(np.arctan(float(camera.tan_fovx))),
                        2 * float(np.arctan(float(camera.tan_fovy))), **kw)


def record_polls(trainer):
    """Wrap ``_poll_gui``: per poll, (the state's step, frames served)."""
    polls, poll = [], trainer._poll_gui
    served = []
    send = trainer.gui.send

    def counting_send(image, verify):
        served.append(image)
        send(image, verify)

    def wrapped(state, active):
        n = len(served)
        poll(state, active)
        polls.append((state.step, len(served) - n))

    trainer.gui.send = counting_send
    trainer._poll_gui = wrapped
    return polls


def test_trainer_serves_a_frame_per_iteration_and_pauses(scene, tmp_path):
    gui = NetworkGUI("127.0.0.1", 0)
    trainer = make_trainer(scene, tmp_path, gui)
    state = trainer.init_state()
    polls = record_polls(trainer)
    cam = scene.test_views[0].camera
    requests = ([view_request(cam)] * 2
                + [view_request(cam, train=False, keep_alive=True)] * 3
                + [view_request(cam)] * 4)
    viewer = Viewer(port_of(gui), requests)
    connect(gui)
    state = trainer.train(state, iterations=6)
    viewer.join()
    # one frame per iteration; the three paused frames and the one that
    # resumes are all served before the third step
    assert polls == [(0, 1), (1, 1), (2, 4), (3, 1), (4, 1), (5, 1)]
    assert state.step == 6
    assert all(len(f) == SIZE * SIZE * 3 for f in viewer.frames) and len(viewer.frames) == 9
    assert viewer.verify == [scene.source_path] * 9
    paused = viewer.frames[2:6]
    assert all(f == paused[0] for f in paused), "the model moved while paused"
    assert viewer.frames[1] != viewer.frames[6], "training did not move the model"
    assert len(set(viewer.frames[0])) > 1, "a frame of the plain background"


def test_trainer_goes_on_after_a_disconnect(scene, tmp_path):
    gui = NetworkGUI("127.0.0.1", 0)
    trainer = make_trainer(scene, tmp_path, gui)
    state = trainer.init_state()
    polls = record_polls(trainer)
    viewer = Viewer(port_of(gui), [view_request(scene.test_views[0].camera)])
    connect(gui)
    state = trainer.train(state, iterations=6)
    viewer.join()
    assert state.step == 6 and gui.conn is None
    assert polls[0] == (0, 1) and [n for _, n in polls[1:]] == [0] * 5


def test_an_overflowing_viewer_frame_is_rendered_again(scene, tmp_path, monkeypatch):
    gui = NetworkGUI("127.0.0.1", 0)
    trainer = make_trainer(scene, tmp_path, gui)
    state = trainer.init_state()
    cam = scene.test_views[0].camera
    assert int(trender(state.model, cam, trainer.bg, testing=True, bin_capacity=64,
                       inference=True).overflow) > 0
    trainer._eval_caps[(SIZE, SIZE)] = 64    # cached for another camera: too small
    received, receive = [], gui.receive
    gui.receive = lambda device: received.append(receive(device)) or received[-1]
    viewer = Viewer(port_of(gui), [view_request(cam)])
    connect(gui)
    trainer._poll_gui(state, True)
    viewer.join()
    got = received[0][0]
    need = measure_bin_capacity(state.model, [got])
    ref = trender(state.model, got, trainer.bg, testing=True, bin_capacity=need,
                  inference=True)
    assert int(ref.overflow) == 0 and trainer._eval_caps[(SIZE, SIZE)] == need
    assert viewer.frames == [(torch.clamp(ref.color, 0, 1) * 255).to(torch.uint8)
                             .numpy().tobytes()]

    # A capacity measure that still leaves the frame short raises.
    gui.drop()
    monkeypatch.setattr(tloop, "measure_bin_capacity", lambda *a, **k: 64)
    trainer._eval_caps.clear()
    viewer = Viewer(port_of(gui), [view_request(cam)], replies=False)
    connect(gui)
    with pytest.raises(RuntimeError, match="overflowed the binning capacity"):
        trainer._poll_gui(state, True)
    gui.drop()
    viewer.join()
