"""The port's autoscale supervisor (``hpnn_tpu_torch.serve.mesh.autoscale``)
against the JAX package's, on the CPU.

After ``tests/test_autoscale.py``: each control-loop case drives both
packages' ``WorkerSupervisor`` through ``tick()`` on the same scripted
desired-workers signal, with an injected spawner (a worker "starts" by
registering in the pool), and the two must act step for step alike: spawn
toward the desired count and its clamp, the cooldown, retiring the
youngest, reaping a dead process, and the ``HPNN_AUTOSCALE_EXEC`` hook with
its failure, its unconfirmed undo and its confirmation.  Then the router's
token in the spawned workers' environment, and one real spawn: a
``--device cpu`` router's supervisor starts a port worker process
(``python -m hpnn_tpu_torch.cli``, never the JAX package's app), which
registers, serves a request, and is retired by drain, then SIGTERM.
"""

import importlib
import time
import types

import numpy as np
import pytest

from test_torch_mesh import N_IN, _close, _post, _wait_quorum, _write_conf

PKGS = ("hpnn_tpu", "hpnn_tpu_torch")


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.serve.mesh.autoscale"),
            importlib.import_module(f"{pkg}.serve.mesh.router"))


class _FakeApp:
    """Just enough app for a supervisor: a real pool and a scripted
    desired-workers signal (``tests/test_autoscale.py``'s)."""

    def __init__(self, router_mod):
        self.pool = router_mod.WorkerPool(eject_after=2)
        self.mesh_router = types.SimpleNamespace(pool=self.pool)
        self.registry = types.SimpleNamespace(device=types.SimpleNamespace(
            type="cpu"))
        self.desired = 1

    def autoscale_snapshot(self):
        return {"queued_rows": 0, "drain_rows_per_s": 0.0,
                "live_workers": self.pool.live_count(),
                "desired_workers": self.desired}


def _spawner(auto_mod):
    count = [0]

    def spawn(sup):
        count[0] += 1
        port = 9100 + count[0]
        addr = f"127.0.0.1:{port}"
        sup.pool.register(addr)
        return auto_mod._Managed(None, addr, port)

    return spawn


def _both(**kw):
    """(app, supervisor) for each package, built alike."""
    out = {}
    for pkg in PKGS:
        auto, router = _mods(pkg)
        app = _FakeApp(router)
        args = dict(min_workers=1, max_workers=2, cooldown_s=0.0,
                    poll_s=3600.0, drain_s=1.0, spawn_fn=_spawner(auto))
        args.update(kw)
        if "exec_hook" in kw:
            args.pop("spawn_fn")
        out[pkg] = (app, auto.WorkerSupervisor(app, "127.0.0.1:1", [],
                                               **args))
    return out


def _drive(pairs, script):
    """Run ``script(app, sup)`` (a list of observations) for each package
    and require equal observations."""
    seen = {}
    try:
        for pkg, (app, sup) in pairs.items():
            seen[pkg] = script(app, sup)
    finally:
        for app, sup in pairs.values():
            sup.close(retire_managed=False)
            app.pool.close()
    assert seen["hpnn_tpu"] == seen["hpnn_tpu_torch"]
    return seen["hpnn_tpu_torch"]


def test_spawn_toward_desired_and_clamp():
    def script(app, sup):
        obs = [sup.tick(), sup.routable_count(), sup.tick()]
        app.desired = 5           # clamps to max 2: one spawn a tick
        obs += [sup.tick(), sup.routable_count(), sup.tick(),
                sup.spawns_total, sup.snapshot()]
        return obs

    got = _drive(_both(), script)
    assert got[:6] == ["spawn", 1, None, "spawn", 2, None]
    assert got[6] == 2 and got[7]["managed"] == 2


def test_cooldown_spaces_actions():
    def script(app, sup):
        app.desired = 2
        obs = [sup.tick(), sup.tick(), sup.spawns_total]
        sup._last_action = time.monotonic() - 31.0
        obs += [sup.tick(), sup.spawns_total]
        return obs

    assert _drive(_both(cooldown_s=30.0), script) == [
        "spawn", None, 1, "spawn", 2]


def test_retire_youngest_down_to_min():
    def script(app, sup):
        app.desired = 2
        obs = [sup.tick(), sup.tick()]
        newest = sup._managed[-1].addr
        app.desired = 1
        obs += [sup.tick(), sup.retires_total,
                newest in app.pool.table(), sup.routable_count()]
        app.desired = 0
        obs += [sup.tick(), sup.routable_count()]
        return obs

    assert _drive(_both(), script) == ["spawn", "spawn", "retire", 1,
                                       False, 1, None, 1]


def test_reap_dead_managed_worker():
    def script(app, sup):
        obs = [sup.tick()]
        addr = sup._managed[0].addr
        sup._managed[0].proc = types.SimpleNamespace(poll=lambda: 1,
                                                     returncode=1)
        sup._reap()
        obs += [len(sup._managed), addr in app.pool.table(), sup.tick()]
        return obs

    assert _drive(_both(), script) == ["spawn", 0, False, "spawn"]


def test_exec_hook_env_and_retire(tmp_path, monkeypatch):
    """The hook replaces both actions with the action, router, desired
    count and victim in its environment; the victim stops routing."""
    def script(app, sup):
        log = tmp_path / f"hook-{id(sup)}.log"
        sup.exec_hook = (
            f'echo "$HPNN_AUTOSCALE_ACTION desired=$HPNN_AUTOSCALE_DESIRED '
            f'router=$HPNN_AUTOSCALE_ROUTER worker=$HPNN_AUTOSCALE_WORKER"'
            f' >> {log}')
        app.desired = 2
        obs = [sup.tick(), sup.spawns_total, sup.snapshot()["managed"],
               sup.snapshot()["pending_confirm"]]
        app.pool.register("127.0.0.1:9201")    # the spawn's confirmation
        app.pool.register("127.0.0.1:9202")
        app.desired = 1
        obs += [sup.tick(), sup.confirmed_total]
        lines = log.read_text().splitlines()
        victim = lines[1].split("worker=")[1]
        obs += [lines[0], lines[1].split(" worker=")[0],
                app.pool.table()[victim]["state"]]
        return obs

    got = _drive(_both(min_workers=0, max_workers=4, exec_hook="true"),
                 script)
    assert got[:6] == ["spawn", 1, 0, "spawn", "retire", 1]
    assert got[6] == "spawn desired=2 router=127.0.0.1:1 worker="
    assert got[7] == "retire desired=1 router=127.0.0.1:1"
    assert got[8] == "retiring"


def test_exec_hook_failure_and_unconfirmed_undo(monkeypatch):
    """A failed retire hook puts the healthy victim straight back; a hook
    that exits 0 but is never confirmed is counted, undone (the victim
    routes again) and retried after the cooldown."""
    monkeypatch.setenv("HPNN_AUTOSCALE_CONFIRM_S", "0.1")

    def failing(app, sup):
        app.pool.register("127.0.0.1:9303")
        app.pool.register("127.0.0.1:9304")
        app.desired = 1
        return [sup.tick(), sup.retires_total,
                sorted(w["state"] for w in app.pool.table().values())]

    assert _drive(_both(min_workers=0, max_workers=4, exec_hook="exit 3"),
                  failing) == [None, 0, ["live", "live"]]

    def unconfirmed(app, sup):
        app.pool.register("127.0.0.1:9305")
        app.pool.register("127.0.0.1:9306")
        app.desired = 1
        obs = [sup.tick(), sup.snapshot()["pending_confirm"], sup.tick()]
        time.sleep(0.15)
        obs += [sup.tick(), sup.unconfirmed_total,
                sorted(w["state"] for w in app.pool.table().values())]
        return obs

    assert _drive(_both(min_workers=0, max_workers=4, exec_hook="true"),
                  unconfirmed) == ["retire", "retire", None, "retire", 1,
                                   ["live", "retiring"]]


def test_spawned_worker_env_carries_auth_token(tmp_path):
    from hpnn_tpu_torch.serve.server import ServeApp

    conf, _ = _write_conf(tmp_path)
    app = ServeApp(max_batch=8, auth_token="sekrit", device="cpu")
    app.enable_mesh_router(required_workers=1, health_interval_s=3600)
    assert app.add_model(conf) is not None
    try:
        sup = app.enable_autoscale("127.0.0.1:1", [conf], start=False)
        assert sup.extra_env == {"HPNN_SERVE_TOKEN": "sekrit"}
        assert sup.device == "cpu"
        snap = app.autoscale_snapshot()
        assert snap["supervisor"]["managed"] == 0
    finally:
        app.close(drain=True)


def test_real_spawn_of_a_port_worker(tmp_path, monkeypatch):
    """A ``--device cpu`` router's supervisor (min 1) spawns one real
    worker process: its command line is the port's CLI on the router's
    device, it registers and serves through the router, and the close
    retires it by drain, then SIGTERM (exit 0)."""
    from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread

    monkeypatch.setenv("HPNN_MESH_HEARTBEAT_S", "0.3")
    conf, _ = _write_conf(tmp_path)
    app = ServeApp(max_batch=16, max_queue_rows=512, device="cpu")
    app.enable_mesh_router(required_workers=1, health_interval_s=0.2)
    assert app.add_model(conf) is not None
    httpd, _ = serve_in_thread(app)
    rport = httpd.server_address[1]
    sup = app.enable_autoscale(f"127.0.0.1:{rport}", [conf],
                               min_workers=1, max_workers=1,
                               cooldown_s=0.0, poll_s=0.1,
                               worker_args=("-b", "16", "--no-warmup"))
    try:
        _wait_quorum(rport, timeout_s=90.0)
        assert sup.spawns_total == 1
        proc = sup._managed[0].proc
        cmd = proc.args
        assert cmd[1:5] == ["-u", "-m", "hpnn_tpu_torch.cli", "serve_nn"]
        assert cmd[cmd.index("--device") + 1] == "cpu"
        assert not any("apps" in c or c.endswith("serve_nn.py")
                       for c in cmd)
        st, body, _ = _post(f"http://127.0.0.1:{rport}",
                            "/v1/kernels/tiny/infer",
                            {"inputs": np.zeros((2, N_IN)).tolist()})
        assert st == 200
        sup.close()
        assert proc.returncode == 0
        assert app.mesh_router.pool.table() == {}
    finally:
        sup.close()
        _close((httpd, app))
