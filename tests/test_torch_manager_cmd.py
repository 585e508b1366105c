"""The port's manager binary (``cmd/manager.main``) against the JAX
package's, in process on the CPU (``--device cpu`` for the port): the
``--once`` reconcile from ``--cluster-json``, as leader, as standby (a
lease already held on the bus the binary builds: return code 3), and
deposed mid-reconcile (another identity takes the lease between the
tick and the PATCH: a ``FencingError``, return code 1). Each package's
exit code, printed lines (the port's own wired and returned lines
aside) and resulting bus must be equal. Then what only the port has:
its wired and returned lines, and ``--device`` defaulting to cuda."""

import importlib
import json
import time

import pytest

ROOTS = ("koordinator_tpu_torch", "koordinator_tpu")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def cluster_json(tmp_path):
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps({
        "nodes": [{"name": f"n{i}", "cpu": 16000 + 4000 * i,
                   "memory": 32768} for i in range(3)],
        "pods": [{"name": "busy", "cpu": 4000, "memory": 2048, "node": "n0"},
                 {"name": "small", "cpu": 500, "memory": 256, "node": "n1"},
                 {"name": "pending", "cpu": 1000, "memory": 512}],
    }))
    return str(path)


def bus_record(root, bus):
    Kind = mod(root, "client.bus").Kind
    return (
        sorted((k, {int(r): v for r, v in n.allocatable.items()},
                dict(n.annotations))
               for k, n in bus.list(Kind.NODE).items()),
        sorted((k, p.node_name) for k, p in bus.list(Kind.POD).items()),
        sorted(bus.list(Kind.RECOMMENDATION)),
    )


def run_main(root, argv, monkeypatch, capsys, held_by=None, steal=False):
    """One package's ``main(argv)`` with the bus it builds recorded: with
    ``held_by``, the bus starts with that identity holding the lease;
    with ``steal``, another identity takes the lease just before the
    reconcile reads the bus."""
    bus_mod = mod(root, "client.bus")
    le = mod(root, "client.leaderelection")
    wiring = mod(root, "client.wiring")
    made = []
    real = bus_mod.APIServer

    def factory():
        bus = real()
        if held_by is not None:
            assert le.LeaderElector(bus, "koord-manager", held_by).tick(
                time.time())
        made.append(bus)
        return bus

    monkeypatch.setattr(bus_mod, "APIServer", factory)
    if steal:
        snapshot = wiring.snapshot_from_bus

        def stolen(bus, now, **kw):
            assert le.LeaderElector(bus, "koord-manager", "thief").tick(
                time.time() + 1000.0)
            return snapshot(bus, now, **kw)

        monkeypatch.setattr(wiring, "snapshot_from_bus", stolen)
    if root == "koordinator_tpu_torch":
        argv = [*argv, "--device", "cpu"]
    rc = mod(root, "cmd.manager").main(argv)
    out = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    lines = [x for x in out if not x.startswith("koord-manager: wired")
             and not x.startswith("koord-manager: reconcile returned")]
    return rc, lines, bus_record(root, made[0]), out


def both(case):
    got = [case(root) for root in ROOTS]
    assert got[0][:3] == got[1][:3]
    return got[0]


COMPONENTS = ("koord-manager components: noderesource, nodeslo, "
              "pod-mutating-webhook, pod-validating-webhook, "
              "quota-topology-guard")


@pytest.mark.parametrize("extra", [[], ["--leader-elect",
                                        "--leader-elect-identity", "me"],
                                   ["--feature-gates",
                                    "PodMutatingWebhook=false"]],
                         ids=["plain", "leader", "gated"])
def test_manager_main_once(tmp_path, monkeypatch, capsys, extra):
    path = cluster_json(tmp_path)
    rc, lines, record, out = both(lambda root: run_main(
        root, ["--once", "--cluster-json", path, *extra], monkeypatch,
        capsys))
    assert rc == 0
    components = (COMPONENTS if not extra or extra[0] != "--feature-gates"
                  else COMPONENTS.replace(" pod-mutating-webhook,", ""))
    assert lines == [components, "noderesource reconcile: 3 nodes synced"]
    # the batch allocatable was PATCHed onto every node of the bus
    assert all(alloc.get(2, 0) > 0 for _, alloc, _ in record[0])
    # the port's own lines: wired on the device, returned 0
    assert out[1].startswith("koord-manager: wired on cpu in ")
    assert "bus seeding" in out[1]
    assert out[-1].startswith("koord-manager: reconcile returned 0 after ")


def test_manager_main_standby_returns_3(tmp_path, monkeypatch, capsys):
    path = cluster_json(tmp_path)
    rc, lines, record, out = both(lambda root: run_main(
        root, ["--once", "--cluster-json", path, "--leader-elect"],
        monkeypatch, capsys, held_by="other"))
    assert rc == 3
    assert lines == [COMPONENTS, "standby: lease held elsewhere"]
    # no reconcile ran: no node gained batch allocatable
    assert all(2 not in alloc for _, alloc, _ in record[0])
    assert out[-1].startswith("koord-manager: reconcile returned 3 after ")


def test_manager_main_deposed_mid_reconcile_returns_1(tmp_path, monkeypatch,
                                                      capsys):
    path = cluster_json(tmp_path)
    rc, lines, record, _ = both(lambda root: run_main(
        root, ["--once", "--cluster-json", path, "--leader-elect",
               "--leader-elect-identity", "me"],
        monkeypatch, capsys, steal=True))
    assert rc == 1
    assert lines == [COMPONENTS, "leadership lost mid-reconcile: me lost "
                                 "lease 'koord-manager'"]
    # the fenced PATCH left the bus's nodes untouched
    assert all(2 not in alloc for _, alloc, _ in record[0])


def test_manager_main_defaults_to_cuda(tmp_path, monkeypatch):
    """No ``--device``: the noderesource step's device is cuda, which
    raises on a machine without one (no fallback to the CPU)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod("koordinator_tpu_torch", "cmd.manager").main(
            ["--once", "--cluster-json", cluster_json(tmp_path)])
