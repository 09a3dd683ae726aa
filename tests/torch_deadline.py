"""A time limit for a test that starts processes: `with deadline(s):`
raises TimeoutError in the test's thread after `s` seconds (SIGALRM), so
that a worker that hangs fails the test instead of stalling the run, and
the test's own clean-up still stops its processes."""
import contextlib
import signal


@contextlib.contextmanager
def deadline(seconds: int):
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
