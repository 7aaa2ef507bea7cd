"""Worker process for the true multi-process distributed tests.

Invoked as a subprocess (never imported by pytest):

    python tests/mp_worker.py <process_id> <num_processes> <port> \
        <extra CLI options...>

Each worker is one "host" of a simulated pod: its own OS process, its
own CPU devices (2 per process via XLA_FLAGS), connected to the others
through jax.distributed's coordination service + gloo collectives.
This is the same `fabber --distributed` entry a real multi-host
run uses (cli.py _run); nothing here is test-only plumbing.
"""

import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    extra = sys.argv[4:]

    # Pin the CPU backend and give each "host" 2 virtual devices so the
    # global mesh is 2*nproc devices.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    from fabber_core_tpu import cli

    argv = extra + [
        "--distributed",
        f"--coordinator-address=localhost:{port}",
        f"--num-processes={nproc}",
        f"--process-id={pid}",
    ]
    rc = cli.execute(argv)
    sys.exit(rc)


if __name__ == "__main__":
    main()
