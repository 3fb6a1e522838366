"""registrar_tpu_torch — the PyTorch port of ``registrar_tpu``.

Registrar is a service-discovery sidecar: it writes this host's IP/ports
into ZooKeeper ephemeral nodes (consumed by Binder to answer DNS A/SRV
queries), keeps them alive with a heartbeat loop, and optionally runs a
periodic command-based health check that deregisters the host while the
check reports it down.

The package keeps ``registrar_tpu``'s module names and layout, so each
module here has a same-named counterpart there.  It imports nothing of
``registrar_tpu`` and nothing of JAX: every module it needs is its own
copy.  The ZooKeeper data contract is byte-for-byte the reference's
(docs/CONTRACT.md) and the operational timing constants are identical.

Layer map:

    __main__.py      ``python3 -m registrar_tpu_torch -f config.json``
    main.py          the daemon: config, logs, connect, signals, restart
    config.py        config file parsing and validation
    jlog.py          bunyan JSON log lines on stdout
    statefile.py     on-disk session handoff state for restarts
    metrics.py       Prometheus /metrics, /status and /debug/trace
    shard.py         the namespace-sharded serve tier (router + workers)
    dnsfront.py      real DNS (UDP + TCP) in front of the shard workers
    zkcache.py       watch-coherent resolve cache with serve-stale
    binderview.py    Binder's view: domain -> A/SRV answers
    tools/zkcli.py   the operator CLI (``serve-sharded``, ``resolve``, ``dig``)
    traceview.py     trace assembly for /debug/trace?id=
    agent.py         register_plus orchestrator
    registration.py  znode registration pipeline
    health.py        periodic command health checker
    reconcile.py     level-triggered registration reconciler
    records.py       the JSON data contract
    zk/              ZooKeeper client and wire codec
    graft_entry.py   the harness MLP in PyTorch (runs on ``cuda`` by default)
"""

import importlib

__version__ = "1.0.0"

# Flat re-export surface, lazy so that subsets of the package can be
# imported without pulling in the whole stack.
_EXPORTS = {
    "register_plus": "registrar_tpu_torch.agent",
    "RegistrarEvents": "registrar_tpu_torch.agent",
    "create_health_check": "registrar_tpu_torch.health",
    "HealthCheck": "registrar_tpu_torch.health",
    "domain_to_path": "registrar_tpu_torch.records",
    "host_record": "registrar_tpu_torch.records",
    "service_record": "registrar_tpu_torch.records",
    "default_address": "registrar_tpu_torch.records",
    "HOST_RECORD_TYPES": "registrar_tpu_torch.records",
    "register": "registrar_tpu_torch.registration",
    "unregister": "registrar_tpu_torch.registration",
    "ZKClient": "registrar_tpu_torch.zk.client",
    "create_zk_client": "registrar_tpu_torch.zk.client",
    "Op": "registrar_tpu_torch.zk.client",
    "MultiError": "registrar_tpu_torch.zk.client",
    "MetricsRegistry": "registrar_tpu_torch.metrics",
    "MetricsServer": "registrar_tpu_torch.metrics",
    "instrument": "registrar_tpu_torch.metrics",
    "instrument_cache": "registrar_tpu_torch.metrics",
    "resolve": "registrar_tpu_torch.binderview",
    "ZKCache": "registrar_tpu_torch.zkcache",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'registrar_tpu_torch' has no attribute {name!r}"
        )
    return getattr(importlib.import_module(mod), name)


__all__ = [*_EXPORTS, "__version__"]
