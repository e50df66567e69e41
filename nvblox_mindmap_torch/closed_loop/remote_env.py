"""The simulator bridge: a policy on one machine drives an environment
served by another, over TCP.

Port of ``nvblox_mindmap_tpu/closed_loop/remote_env.py``. The wire format
is the JAX package's, byte for byte, so a client of either package drives
a server of either package (the sim-host split of
``docs/pages/closed_loop_evaluation.md``). Messages are length-prefixed
(8-byte big-endian size) in a restricted tagged codec: only None, bool,
int, float, str, bytes, numpy arrays (no object dtypes), lists and dicts
with str keys are expressible, so neither peer can make the other run
code (no pickle). One request and one reply per call of the
``EnvironmentBase`` surface.

Security model: the link is a trusted point-to-point channel. The server
binds 127.0.0.1 by default; reach it from another machine through an SSH
tunnel, or pass ``host=`` on a network known to be private.

- Sim host: ``serve_environment(env, port)`` serves any ``EnvironmentBase``
  (the Isaac Lab adapter, the scene world).
- Policy host: ``RemoteEnvironment(host, port)`` is an ``EnvironmentBase``
  over the server; the closed-loop runner and policies are unchanged. It
  counts its calls and the bytes it moves (``calls``, ``bytes_sent``,
  ``bytes_received``).

The environments' contract is host numpy (``closed_loop/environment.py``).
Where the server reads an environment's arrays, a torch tensor on the CPU
becomes numpy; a tensor on a card raises, naming the field: nothing is
copied off a card unasked.
"""
from __future__ import annotations

import select
import socket
import struct
import sys
import threading
from typing import Dict, Optional

import numpy as np

from nvblox_mindmap_torch.closed_loop.environment import CameraFrame, EnvironmentBase

_HEADER = struct.Struct("!Q")
_U32 = struct.Struct("!I")
_F64 = struct.Struct("!d")
_I64 = struct.Struct("!q")

# --- the restricted codec ---------------------------------------------------
# Decoding never constructs arbitrary objects, so a hostile peer is limited
# to malformed-data errors.

_MAX_MSG_BYTES = 1 << 30  # 1 GiB bound on any one message or array


def _enc(obj, out: list) -> None:
    if obj is None:
        out.append(b"N")
    elif isinstance(obj, (bool, np.bool_)):
        # Before the integers: np.bool_ is neither a bool nor an np.integer,
        # and is_success() often returns one (``(dist < tol).all()``).
        out.append(b"T" if obj else b"F")
    elif isinstance(obj, (int, np.integer)):
        out.append(b"i" + _I64.pack(int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(b"f" + _F64.pack(float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(b"s" + _U32.pack(len(raw)) + raw)
    elif isinstance(obj, bytes):
        out.append(b"b" + _U32.pack(len(obj)) + obj)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        dt = arr.dtype.str.encode("ascii")  # e.g. b'<f4'
        head = (b"a" + _U32.pack(len(dt)) + dt + _U32.pack(arr.ndim)
                + b"".join(_U32.pack(int(s)) for s in arr.shape))
        out.append(head + _HEADER.pack(arr.nbytes))
        out.append(_array_bytes(arr))
    elif isinstance(obj, (list, tuple)):
        out.append(b"l" + _U32.pack(len(obj)))
        for item in obj:
            _enc(item, out)
    elif isinstance(obj, dict):
        out.append(b"d" + _U32.pack(len(obj)))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"codec only supports str dict keys, got {key!r}")
            _enc(key, out)
            _enc(value, out)
    else:
        raise TypeError(f"type not expressible in the remote-env codec: {type(obj)}")


def _array_bytes(arr: np.ndarray):
    """A C-contiguous array's bytes: a view of its memory where its dtype
    has a buffer format, else a copy (datetimes, objects)."""
    try:
        return memoryview(arr).cast("B")
    except (TypeError, ValueError):
        return arr.tobytes()


class _Reader:
    """Reads a message through a memoryview: slices are views, not copies."""

    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated message")
        chunk = self.buf[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def u32(self) -> int:
        return _U32.unpack(self.take(_U32.size))[0]


def _dec(r: _Reader):
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return _I64.unpack(r.take(_I64.size))[0]
    if tag == b"f":
        return _F64.unpack(r.take(_F64.size))[0]
    if tag == b"s":
        return str(r.take(r.u32()), "utf-8")
    if tag == b"b":
        return bytes(r.take(r.u32()))
    if tag == b"a":
        dt = np.dtype(str(r.take(r.u32()), "ascii"))
        if dt.hasobject:
            raise ValueError("object dtypes are not allowed")
        shape = tuple(r.u32() for _ in range(r.u32()))
        (nbytes,) = _HEADER.unpack(r.take(_HEADER.size))
        if nbytes > _MAX_MSG_BYTES:
            raise ValueError("array too large")
        return np.frombuffer(r.take(nbytes), dtype=dt).reshape(shape).copy()
    if tag == b"l":
        return [_dec(r) for _ in range(r.u32())]
    if tag == b"d":
        return {_dec(r): _dec(r) for _ in range(r.u32())}
    raise ValueError(f"unknown codec tag {tag!r}")


def encode_message(obj) -> bytes:
    out: list = []
    _enc(obj, out)
    return b"".join(out)


def decode_message(payload: bytes):
    r = _Reader(payload)
    obj = _dec(r)
    if r.pos != len(payload):
        raise ValueError("trailing bytes in message")
    return obj


def host_array(value, field: str) -> np.ndarray:
    """``np.asarray(value)``, where a torch tensor on the CPU becomes its
    numpy view and one on a card raises, naming ``field``."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise TypeError(f"{field}: a tensor on {value.device}; the bridge moves host "
                            "arrays only (copy it to the host first)")
        value = value.detach().numpy()
    return np.asarray(value)


# --- framing ------------------------------------------------------------------


def _send_msg(sock: socket.socket, obj) -> int:
    """Sends one message (the bytes of ``_HEADER`` + ``encode_message``) in
    one gathered write, arrays straight from their memory; returns the
    bytes sent."""
    out: list = []
    _enc(obj, out)
    chunks, small = [], bytearray()
    for part in out:  # the small encodings coalesced between arrays
        if isinstance(part, memoryview):
            chunks += [bytes(small), part]
            small = bytearray()
        else:
            small += part
    chunks.append(bytes(small))
    size = sum(len(c) for c in chunks)
    views = [memoryview(_HEADER.pack(size))] + [memoryview(c) for c in chunks if len(c)]
    while views:
        sent = sock.sendmsg(views)
        while sent:
            if sent >= len(views[0]):
                sent -= len(views.pop(0))
            else:
                views[0], sent = views[0][sent:], 0
    return _HEADER.size + size


def _recv_exactly(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_payload(sock: socket.socket) -> bytearray:
    (size,) = _HEADER.unpack(_recv_exactly(sock, _HEADER.size))
    if size > _MAX_MSG_BYTES:
        raise ValueError(f"message of {size} bytes exceeds protocol bound")
    return _recv_exactly(sock, size)


def _no_delay(sock: socket.socket) -> socket.socket:
    """Small requests and replies go out at once (no Nagle delay)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def _recv_msg(sock: socket.socket):
    return decode_message(_recv_payload(sock))


# --- the client ---------------------------------------------------------------


class RemoteEnvironment(EnvironmentBase):
    """EnvironmentBase client speaking to a served environment."""

    def __init__(self, host: str, port: int, timeout_s: float = 60.0):
        self._sock = _no_delay(socket.create_connection((host, port), timeout=timeout_s))
        self._lock = threading.Lock()
        self.calls = 0
        self.bytes_sent = 0
        self.bytes_received = 0

    def _call(self, method: str, **kwargs):
        with self._lock:
            sent = _send_msg(self._sock, {"method": method, "kwargs": kwargs})
            payload = _recv_payload(self._sock)
            self.calls += 1
            self.bytes_sent += sent
            self.bytes_received += _HEADER.size + len(payload)
        reply = decode_message(payload)
        if reply.get("error"):
            raise RuntimeError(f"remote environment error: {reply['error']}")
        return reply.get("result")

    def reset(self) -> None:
        self._call("reset")

    def step(self, goal_policy_state: Optional[np.ndarray]) -> None:
        goal = None if goal_policy_state is None else host_array(goal_policy_state, "goal")
        self._call("step", goal=goal)

    def get_robot_state(self) -> np.ndarray:
        return np.asarray(self._call("get_robot_state"))

    def get_policy_state(self) -> np.ndarray:
        return np.asarray(self._call("get_policy_state"))

    def get_cameras(self) -> Dict[str, CameraFrame]:
        raw = self._call("get_cameras")
        return {name: CameraFrame(f["rgb"], f["depth"], f["intrinsics"], f["pose7"],
                                  f.get("segmentation"))
                for name, f in raw.items()}

    @property
    def semantic_id_to_class(self) -> Dict[int, str]:
        return {int(k): v for k, v in (self._call("semantic_id_to_class") or {}).items()}

    def get_object_poses(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in (self._call("get_object_poses") or {}).items()}

    def is_success(self) -> bool:
        return bool(self._call("is_success"))

    @property
    def done(self) -> bool:
        return bool(self._call("done"))

    def close(self):
        try:
            self._call("shutdown")
        except Exception:
            pass
        self._sock.close()


# --- the server ---------------------------------------------------------------


def _frame_dict(name: str, f: CameraFrame) -> Dict[str, Optional[np.ndarray]]:
    seg = getattr(f, "segmentation", None)
    return {
        "rgb": host_array(f.rgb, f"{name}.rgb"),
        "depth": host_array(f.depth, f"{name}.depth"),
        "intrinsics": host_array(f.intrinsics, f"{name}.intrinsics"),
        "pose7": host_array(f.pose7, f"{name}.pose7"),
        "segmentation": None if seg is None else host_array(seg, f"{name}.segmentation"),
    }


def _handle_client(conn: socket.socket, env: EnvironmentBase, stop_event):
    try:
        while not stop_event.is_set():
            # Poll between messages, so stop() can end an idle connected
            # client (a blocking recv would hold this thread past stop's
            # join); a message that starts arriving is read whole.
            readable, _, _ = select.select([conn], [], [], 0.5)
            if not readable:
                continue
            try:
                request = _recv_msg(conn)
            except (ConnectionError, EOFError, ValueError, OSError):
                # A disconnect or a malformed message drops this client; the
                # server stays up for the next one.
                return
            try:
                method = request["method"]
                kwargs = request.get("kwargs", {})
            except (KeyError, TypeError):
                _try_send_error(conn, "malformed request")
                continue
            try:
                if method == "shutdown":
                    _send_msg(conn, {"result": None})
                    stop_event.set()
                    return
                if method == "reset":
                    result = env.reset()
                elif method == "step":
                    result = env.step(kwargs.get("goal"))
                elif method == "get_robot_state":
                    result = host_array(env.get_robot_state(), "robot_state")
                elif method == "get_policy_state":
                    result = host_array(env.get_policy_state(), "policy_state")
                elif method == "get_cameras":
                    result = {name: _frame_dict(name, f)
                              for name, f in env.get_cameras().items()}
                elif method == "semantic_id_to_class":
                    result = {str(int(k)): str(v) for k, v in env.semantic_id_to_class.items()}
                elif method == "get_object_poses":
                    result = {str(k): host_array(v, f"object_poses.{k}")
                              for k, v in env.get_object_poses().items()}
                elif method == "is_success":
                    result = env.is_success()
                elif method == "done":
                    result = env.done
                else:
                    raise ValueError(f"unknown method {method}")
                _send_msg(conn, {"result": result})
            except Exception as e:  # reported to the client; the server goes on
                if not _try_send_error(conn, repr(e)):
                    return  # the client left mid-reply
    finally:
        conn.close()


def _try_send_error(conn, message: str) -> bool:
    """Best-effort error reply; False if the client's connection is dead.

    A failed send here must not propagate: it would end the accept loop while
    the listener stays bound, and every later client would hang.
    """
    try:
        _send_msg(conn, {"error": message})
        return True
    except Exception:
        return False


class EnvironmentServer:
    """Serves one EnvironmentBase on a TCP port (one client at a time)."""

    def __init__(self, env: EnvironmentBase, host: str = "127.0.0.1", port: int = 0):
        self.env = env
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def start(self) -> "EnvironmentServer":
        self._thread.start()
        return self

    def _serve(self):
        self._listener.settimeout(0.5)
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return  # the listener was closed by stop()
                # A crashing handler must never end the accept loop: the port
                # would stay bound to a dead server.
                try:
                    _handle_client(_no_delay(conn), self.env, self._stop)
                except Exception:
                    try:
                        conn.close()
                    except OSError:
                        pass
        finally:
            self._listener.close()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the server stops (a client's ``close`` asks it to);
        True once it has."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # Close the listener even if the serving thread is stuck, so the port
        # is released and a rebind cannot fail with EADDRINUSE.
        try:
            self._listener.close()
        except OSError:
            pass


def serve_environment(env: EnvironmentBase, host: str = "127.0.0.1",
                      port: int = 5555) -> EnvironmentServer:
    """Serve ``env`` from a background thread; returns the started server.

    Binds loopback by default; to serve across machines, tunnel the port
    (``ssh -L``) or pass an explicit ``host`` on a trusted private network.
    The wire format is the restricted codec above, no pickle.
    """
    return EnvironmentServer(env, host, port).start()
