"""Failure detection: deadlines and retries around device work.

The reference's only failure detector is bounded busy/done polling with
error printouts (``NTT_PCIECommunicationv2.c:56-103``,
``NTT_PCIEComunicationv4.c:291-303``).  XLA dispatch is synchronous, so
the analog is a deadline on the blocking call: run it on a worker thread,
raise :class:`DeviceTimeout` if the device (or its transport) wedges, and
optionally retry.

The worker thread is left running after a timeout (a blocked device call
cannot be cancelled from Python); callers should treat DeviceTimeout as
"give up on this device session", checkpoint (utils/checkpoint.py) and
restart — the same recovery posture as the reference's mandated reboot
after reprogramming (Software_Hardware_Comunnicator/README.md:24-26).
"""

from __future__ import annotations

import concurrent.futures
import time

__all__ = ["DeviceTimeout", "with_deadline", "retry"]


class DeviceTimeout(TimeoutError):
    """A device call exceeded its deadline (device/transport wedged).

    ``pending`` holds the still-running future of the wedged call (a
    blocked device call cannot be cancelled from Python); callers that
    intend to retry should wait for it to settle first — running a
    second identical dispatch concurrently on the same runtime is how
    two wedged calls become an interleaved mess.  :func:`retry` does
    this automatically."""

    def __init__(self, msg: str, pending=None):
        super().__init__(msg)
        self.pending = pending


def with_deadline(fn, timeout_s: float, *args, **kwargs):
    """Run fn(*args) on a worker thread; raise DeviceTimeout (carrying
    the still-running future as ``.pending``) if it does not finish
    within timeout_s."""
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(fn, *args, **kwargs)
    try:
        return fut.result(timeout=timeout_s)
    except concurrent.futures.TimeoutError:
        raise DeviceTimeout(
            f"device call exceeded {timeout_s:.0f}s deadline — transport "
            f"may be wedged; checkpoint and restart the session",
            pending=fut) from None
    finally:
        ex.shutdown(wait=False)


def retry(fn, attempts: int = 3, timeout_s: float | None = None,
          backoff_s: float = 30.0):
    """Call fn up to ``attempts`` times, with an optional per-attempt
    deadline and linear backoff between attempts.  Returns fn's result or
    re-raises the last failure.

    After a DeviceTimeout the backoff window doubles as a drain wait on
    the wedged attempt's future, so the next attempt never overlaps a
    prior call that is still executing on the runtime (if the wedged
    call completed meanwhile, its result is returned directly)."""
    last: Exception | None = None
    for i in range(attempts):
        try:
            if timeout_s is None:
                return fn()
            return with_deadline(fn, timeout_s)
        except Exception as e:                      # noqa: BLE001
            last = e
            if i + 1 < attempts:
                wait = backoff_s * (i + 1)
                pending = getattr(e, "pending", None)
                if pending is not None:
                    try:
                        # drain instead of sleeping: a late success is a
                        # success
                        return pending.result(timeout=wait)
                    except concurrent.futures.TimeoutError:
                        pass                         # still wedged; retry
                    except Exception:                # noqa: BLE001
                        pass                         # failed late; retry
                else:
                    time.sleep(wait)
    raise last
