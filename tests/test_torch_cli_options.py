"""Every option of the JAX package's CLIs against the port's, on the CPU.

The JAX package's option tables (``hpnn_tpu/cli.py``: ``_LONG_OPTS``,
``_LONG_INT_OPTS``, ``_LONG_CHOICE_OPTS``, ``--resume``, and its serve_nn
parser, read off the ``argparse`` object its ``serve_nn_main`` builds) are
walked: every option it accepts, the port takes, or refuses with a line of
its own (the XLA compilation cache, the in-process data mesh); an option
either package refuses for a command gets the JAX package's stderr and exit
code (the reference's ``syntax error: unrecognized option!`` with the
command's usage text on stdout for train_nn/run_nn; argparse's error line
and exit code 2 for serve_nn).  No option is answered with a "later
slice" line any more.
"""

import argparse
import contextlib
import io

import pytest

import hpnn_tpu.cli as jax_cli
import hpnn_tpu_torch.cli as port_cli

COMMANDS = ("train_nn", "run_nn")


def _jax_options(name):
    """(option, value or None, accepted) for every long option of the JAX
    package's train_nn/run_nn tables, as its parser decides for ``name``."""
    train = name == "train_nn"
    out = []
    for key in jax_cli._LONG_OPTS:
        out.append((key, "x", True))
    for key in jax_cli._LONG_INT_OPTS:
        out.append((key, "2", train or key in jax_cli._SHARED_INT_OPTS))
    for key, (_, choices, shared) in jax_cli._LONG_CHOICE_OPTS.items():
        out.append((key, choices[0], train or shared))
    out.append(("--resume", None, train))
    return out


def _call(fn, argv):
    """(return or SystemExit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = fn(argv)
        except SystemExit as exc:
            rc = ("exit", exc.code)
    return rc, out.getvalue(), err.getvalue()


def _jax_parse(name):
    return lambda argv: jax_cli._parse_args(argv, name,
                                            train=name == "train_nn")


def _port_parse(name):
    return lambda argv: port_cli._parse_args(argv, name)


@pytest.mark.parametrize("name", COMMANDS)
def test_every_jax_option_is_taken_or_refused_with_its_own_line(name):
    from hpnn_tpu_torch.utils import nn_log

    refusal = f"{name}: --compile-cache {port_cli._COMPILE_CACHE_REFUSAL}\n"
    for key, value, accepted in _jax_options(name):
        argv = [key] + ([value] if value is not None else []) + ["nn.conf"]
        jrc, jout, jerr = _call(_jax_parse(name), argv)
        prc, pout, perr = _call(_port_parse(name), argv)
        nn_log.set_verbosity(0)
        assert "later slice" not in perr and "not ported" not in perr
        if not accepted:
            # refused by both: the JAX package's stderr and exit code, and
            # each package's usage text
            assert jrc == prc == ("exit", -1), key
            assert perr == jerr == "syntax error: unrecognized option!\n"
            assert pout == port_cli._help_text(name)
            assert jout == jax_cli._help_text(name, name == "train_nn")
        elif key == "--compile-cache":
            assert jrc[0] == "nn.conf"
            assert prc == ("exit", -1) and perr == refusal
        else:
            assert jrc[0] == prc[0] == "nn.conf", (key, perr)
            assert perr == jerr == "", key


@pytest.mark.parametrize("name", COMMANDS)
@pytest.mark.parametrize("opt", ["--bogus", "--bogus=1", "--device-x",
                                 "-q"])
def test_unknown_option_gets_the_jax_answer(name, opt):
    from hpnn_tpu_torch.utils import nn_log

    jrc, jout, jerr = _call(_jax_parse(name), [opt, "nn.conf"])
    prc, pout, perr = _call(_port_parse(name), [opt, "nn.conf"])
    nn_log.set_verbosity(0)
    assert jrc == prc == ("exit", -1)
    assert perr == jerr == "syntax error: unrecognized option!\n"
    assert pout == port_cli._help_text(name)
    assert jout == jax_cli._help_text(name, name == "train_nn")


def _jax_serve_parser(monkeypatch):
    """The argparse object the JAX package's serve_nn_main builds."""
    seen = []

    class _Stop(Exception):
        pass

    def grab(self, *a, **k):
        seen.append(self)
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Stop):
        jax_cli.serve_nn_main(["nn.conf"])
    monkeypatch.undo()
    return seen[0]


def test_every_jax_serve_option_is_taken_or_refused(monkeypatch, tmp_path,
                                                    capsys):
    jax_ap = _jax_serve_parser(monkeypatch)
    port_ap = port_cli._serve_parser()
    jax_opts = {o for a in jax_ap._actions for o in a.option_strings}
    port_opts = {o for a in port_ap._actions for o in a.option_strings}
    refused = set(port_cli._SERVE_OWN_REFUSALS)
    assert refused == {"--compile-cache", "--mesh"}
    missing = jax_opts - port_opts - refused
    assert not missing, sorted(missing)
    assert not refused & port_opts
    # the port's only addition is its device choice
    assert port_opts - jax_opts == {"--device"}
    conf = tmp_path / "nn.conf"
    conf.write_text("[name] x\n")
    for key in sorted(refused):
        assert port_cli.serve_app([key, "1", "--device", "cpu",
                                   str(conf)]) == (None, 2)
        assert capsys.readouterr().err == \
            f"serve_nn: {key} {port_cli._SERVE_OWN_REFUSALS[key]}\n"


@pytest.mark.parametrize("argv", [["--bogus"], ["--bogus=1", "-z"]])
def test_unknown_serve_option_gets_the_jax_answer(argv, capsys, tmp_path):
    conf = str(tmp_path / "nn.conf")
    with pytest.raises(SystemExit) as exc:
        jax_cli.serve_nn_main([*argv, conf])
    jerr = capsys.readouterr().err
    assert port_cli.serve_app([*argv, "--device", "cpu", conf]) == \
        (None, exc.value.code)
    perr = capsys.readouterr().err
    assert exc.value.code == 2
    assert perr.splitlines()[-1] == jerr.splitlines()[-1]
    assert perr.splitlines()[-1].startswith(
        "serve_nn: error: unrecognized arguments: ")
    assert perr.startswith("usage: serve_nn ")
