"""ceph daemon <asok> <command...>: admin-socket client CLI.

Port of ``tools/ceph_daemon.py`` (the same protocol: it talks to either
package's daemons).  Reference: the `ceph daemon` path of src/ceph.in,
talking to src/common/admin_socket.cc.  Examples:

    python -m ceph_tpu_torch.tools.ceph_daemon /path/osd.0.asok perf dump
    python -m ceph_tpu_torch.tools.ceph_daemon /path/osd.0.asok config show
    python -m ceph_tpu_torch.tools.ceph_daemon /path/osd.0.asok \
        config set key=osd_tick_interval value=1
    python -m ceph_tpu_torch.tools.ceph_daemon /path/osd.0.asok help
"""

import asyncio
import json
import sys

from ceph_tpu_torch.utils.admin_socket import admin_command


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    path = argv[0]
    words = [a for a in argv[1:] if "=" not in a]
    fields = dict(a.split("=", 1) for a in argv[1:] if "=" in a)
    prefix = " ".join(words)
    out = asyncio.new_event_loop().run_until_complete(
        admin_command(path, prefix, **fields)
    )
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
