"""One process cluster of the port's tests at a time.

The tier-1 run spreads test files over several workers, but a process
cluster is 4 to 13 daemon processes of its own, each loading torch: two
or three clusters booting at once beside the other workers' tests
overload the host, and timing-bound tests elsewhere miss their deadlines.
The tests that start daemons take this lock (a ``flock`` on a file in the
run's temporary directory, which every worker shares) for their whole
run."""

import contextlib
import fcntl
import os
import tempfile


@contextlib.contextmanager
def one_cluster_at_a_time():
    path = os.path.join(tempfile.gettempdir(),
                        "ceph_tpu_torch-process-clusters.lock")
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
