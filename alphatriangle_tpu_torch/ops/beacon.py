"""The progress-beacon writer and its host drainer (no TPU kernel: the
JAX package's beacons are `jax.debug.callback`s; see `csrc/beacon.cu`).

The function: claim the next slot of `ring`, an (S, 4) int64 tensor of
`(seq, phase, index, program)` rows, from `counter`, and write the row
with its sequence number last. `beacon_cuda` launches the hand-written
kernel on the current stream (the ring in pinned host memory, passed by
its device address); `beacon_plain` does the same in tensor operations
(on the CPU, or on a card's device memory for the comparison).

`BeaconRing` owns one device's ring in mapped pinned memory, its device
counter (zeroed before any stream can use it), the phase and program
names interned to the ids the kernel writes, and a drainer thread that
turns published slots into `beacons.jsonl` rows
(`telemetry.device_stats.write_beacon_row`) every `poll_s`. `emit`
dispatches by the ring's device: the kernel on a card, the plain
version on the CPU, so the drain can be tested there.
`drain()` turns the published slots into rows at once, under the ring's
lock; the wedge path calls it (through `drain_all`) before it reads the
last row. `ring_for(device)` makes a device's ring at its first armed
beacon; `stop_all` drains and stops every ring.
"""

import ctypes
import threading

import torch

from ._cuda import CudaKernel, check_cuda, stream_ptr

KERNEL = CudaKernel(
    "beacon",
    "beacon.cu",
    "beacon_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p],
)

RING_SLOTS = 4096  # rows in flight before the drainer must have read them
ROW_WORDS = 4  # seq, phase id, index, program id


def beacon_plain(counter: torch.Tensor, ring: torch.Tensor, phase: int, index: int, program: int) -> None:
    """The kernel's function in tensor operations on the counter's device
    (no host read, so on a card it runs in stream order too): row
    `counter % S` becomes (counter + 1, phase, index, program), then the
    counter steps."""
    n = counter[0]
    ids = [torch.full_like(n, v) for v in (phase, index, program)]
    ring.index_copy_(0, (counter % ring.shape[0]), torch.stack([n + 1, *ids])[None])
    counter.add_(1)


def beacon_cuda(counter: torch.Tensor, ring_device_ptr: int, slots: int, phase: int, index: int,
                program: int) -> None:
    """One launch of the kernel on the current stream; `ring_device_ptr`
    is the device address of a pinned (slots, 4) int64 ring."""
    check_cuda("beacon counter", counter, torch.int64, (1,))
    KERNEL.launch(counter.data_ptr(), ring_device_ptr, slots, phase, index, program, stream_ptr(counter))


def device_pointer(host: torch.Tensor) -> int:
    """The device address of a pinned host tensor; raises unless the card
    can reach it (mapped pinned memory)."""
    if not host.is_pinned():
        raise ValueError("beacon ring: expected pinned host memory")
    KERNEL.load()
    fn = KERNEL.function("beacon_device_pointer", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)])
    out = ctypes.c_void_p()
    rc = fn(host.data_ptr(), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"beacon ring: cudaHostGetDevicePointer failed ({KERNEL.error(rc)})")
    return int(out.value)


def _zeroed_counter(device: torch.device) -> torch.Tensor:
    """The ring's counter, zero before this returns. The ring is made at
    the first armed site, on whichever thread reaches one, and every
    producer stream then adds to the counter: a fill queued on the
    caller's stream, behind its work in flight, would be ordered before
    none of them. So the fill goes on a stream of its own, with nothing
    in front of it, and the host waits for it."""
    if device.type != "cuda":
        return torch.zeros((1,), dtype=torch.int64, device=device)
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        counter = torch.zeros((1,), dtype=torch.int64, device=device)
    side.synchronize()
    return counter


class BeaconRing:
    """One device's beacon ring, its id tables and its drainer."""

    def __init__(self, device, slots: int = RING_SLOTS, poll_s: float = 0.02):
        self.device = torch.device(device)
        self.slots = int(slots)
        self.poll_s = poll_s
        cuda = self.device.type == "cuda"
        self.host = torch.zeros((self.slots, ROW_WORDS), dtype=torch.int64, pin_memory=cuda)
        self.counter = _zeroed_counter(self.device)
        self._ring_ptr = device_pointer(self.host) if cuda else None
        self._view = self.host.numpy()  # every read below is a fresh load
        self._names: dict = {}  # (kind, name) -> id
        self._by_id: dict = {("program", 0): None}
        self._next = 1  # the sequence number the drain expects next
        self.dropped = 0  # rows the ring wrapped over before the drain
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="beacon-drainer", daemon=True)
        self._thread.start()

    def _intern(self, kind: str, name) -> int:
        if name is None:
            return 0
        key = (kind, name)
        with self._lock:
            i = self._names.get(key)
            if i is None:
                i = self._names[key] = len(self._names) + 1
                self._by_id[(kind, i)] = name
        return i

    def emit(self, phase: str, index: int, program: "str | None") -> None:
        """Enqueue one row on the current stream (CPU: write it now)."""
        p, g = self._intern("phase", phase), self._intern("program", program)
        if self._ring_ptr is not None:
            beacon_cuda(self.counter, self._ring_ptr, self.slots, p, int(index), g)
        else:
            with self._lock:
                beacon_plain(self.counter, self.host, p, int(index), g)

    def drain(self) -> int:
        """Every published slot in sequence order into rows; returns the
        rows written."""
        from ..telemetry.device_stats import write_beacon_row

        rows = []
        with self._lock:
            view = self._view
            while True:
                slot = view[(self._next - 1) % self.slots]
                seq = int(slot[0])
                if seq < self._next:
                    break  # not published yet
                if seq == self._next:
                    phase, index, program = int(slot[1]), int(slot[2]), int(slot[3])
                    if int(slot[0]) == seq:
                        rows.append((
                            self._by_id.get(("phase", phase)), index,
                            self._by_id.get(("program", program)),
                        ))
                        self._next += 1
                        continue
                # Overwritten by a newer row before it was read.
                self.dropped += 1
                self._next += 1
        for phase, index, program in rows:
            write_beacon_row(phase, index, program)
        return len(rows)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.drain()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.drain()


_RINGS: dict = {}
_RINGS_LOCK = threading.Lock()


def ring_for(device) -> BeaconRing:
    """The device's ring, made (and its drainer started) on first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = BeaconRing(device)
    return ring


def drain_all() -> int:
    with _RINGS_LOCK:
        rings = list(_RINGS.values())
    return sum(r.drain() for r in rings)


def stop_all() -> None:
    with _RINGS_LOCK:
        rings = list(_RINGS.values())
        _RINGS.clear()
    for r in rings:
        r.stop()
