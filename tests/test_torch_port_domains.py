"""The port's domain registry and encoder-freeze transfer (domains/)
against the JAX package's, on the CPU.

Registry: the port's copy gives the JAX package's built-in table, the
same DataConfig for every built-in spec, and the same error for every bad
spec, registry and registry file. Transfer: the port's frozen set on the
full-width generator is exactly the JAX package's 16 leaves (names only:
the JAX tree comes from ``jax.eval_shape``, no forward runs); a frozen
step on the small CycleGAN of tests/test_torch_port_train.py keeps those
leaves bitwise with ``health/gnorm_enc_frozen`` 0, as the JAX package's
frozen step does; ``restore_parent`` moves weights only. Then the CLI:
``--domain`` through a registry file, ``--strict_domain`` on resume, and
a transfer run with FusedProp and accumulation.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu import config as jc
from cyclegan_tpu.domains import registry as jax_registry
from cyclegan_tpu.domains import transfer as jax_transfer
from cyclegan_tpu.models.generator import ResNetGenerator as JaxGenerator
from cyclegan_tpu.train.steps import make_train_step as jax_train_step
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch import main as port_main
from cyclegan_tpu_torch.convert import flax_key, state_from_flax
from cyclegan_tpu_torch.domains import registry, transfer
from cyclegan_tpu_torch.models import ResNetGenerator
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.train.steps import make_grad_fn, make_train_step
from cyclegan_tpu_torch.utils import summary as port_summary
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer, save_meta

from tests.test_torch_port_main import ARGS
from tests.test_torch_port_train import (
    BATCH,
    CONFIG,
    JAX_CONFIG,
    _inputs,
    _jax,
    _numpy_state,
)


# -- registry ----------------------------------------------------------------

def test_builtin_table_and_data_configs_are_jaxs():
    ours = [dataclasses.asdict(s) for s in registry.BUILTIN_SPECS]
    theirs = [dataclasses.asdict(s) for s in jax_registry.BUILTIN_SPECS]
    assert ours == theirs
    assert registry.DEFAULT_DOMAIN == jax_registry.DEFAULT_DOMAIN
    reg, jax_reg = registry.default_registry(), jax_registry.default_registry()
    assert reg.keys() == jax_reg.keys() and reg.groups() == jax_reg.groups()
    for key in reg.keys():
        mine = dataclasses.asdict(registry.data_config_for(reg.resolve(key)))
        want = dataclasses.asdict(jax_registry.data_config_for(
            jax_reg.resolve(key)))
        assert mine == {k: want[k] for k in mine}, key
        assert isinstance(pc.DataConfig(**mine), pc.DataConfig)


BAD_SPECS = [dict(key="Horse2Zebra"), dict(key="pair", source="s3"),
             dict(key="pair", source="folder"),
             dict(key="pair", source="synthetic", data_dir="/x"),
             dict(key="pair", resize_size=128, crop_size=256),
             dict(key="pair", resize_size=0),
             dict(key="pair", group="Bad Group")]


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_bad_specs_fail_as_jaxs_do(kw):
    errors = []
    for module in (registry, jax_registry):
        with pytest.raises(module.DomainError) as e:
            module.DomainSpec(**kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _errors(fn):
    out = []
    for module in (registry, jax_registry):
        with pytest.raises(module.DomainError) as e:
            fn(module)
        out.append(str(e.value))
    assert out[0] == out[1]
    return out[0]


def test_registry_errors_are_jaxs(tmp_path):
    assert "duplicate" in _errors(lambda m: m.DomainRegistry(
        [m.DomainSpec(key="pair"), m.DomainSpec(key="pair")]))
    assert "mixes crop sizes" in _errors(lambda m: m.DomainRegistry([
        m.DomainSpec(key="a2b", group="shared", crop_size=256),
        m.DomainSpec(key="c2d", group="shared", crop_size=128,
                     resize_size=143)]))
    assert "unknown domain" in _errors(
        lambda m: m.default_registry().resolve("zebra2horse"))
    assert "unknown shared-generator" in _errors(
        lambda m: m.default_registry().group_members("nope"))
    for name, doc in (("typo", {"domains": [{"key": "p", "agument_flip": 0}]}),
                      ("shape", {"domains": {"key": "p"}}),
                      ("top", ["p"]), ("entry", {"domains": ["p"]}),
                      ("type", {"domains": [{"key": "p", "crop_size": "x"}]})):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(doc))
        _errors(lambda m: m.load_registry_file(str(path)))
    for bad in (("Bad Domain", "base"), ("horse2zebra", "a/b"),
                ("horse2zebra", "")):
        _errors(lambda m: m.tenant_key(*bad))
    assert registry.tenant_key("maps", "int8") == "maps/int8"


def test_registry_file_merges_over_the_builtins(tmp_path):
    path = tmp_path / "domains.json"
    path.write_text(json.dumps({"domains": [
        {"key": "scans2sketch", "source": "folder",
         "data_dir": str(tmp_path), "augment_flip": False},
        {"key": "horse2zebra", "source": "folder",
         "data_dir": str(tmp_path)}]}))
    reg = registry.default_registry(str(path))
    assert reg.resolve("scans2sketch").augment_flip is False
    assert reg.resolve("horse2zebra").source == "folder"
    assert "apple2orange" in reg


# -- the freeze mask ---------------------------------------------------------

def test_frozen_set_is_jaxs_sixteen_leaves_at_full_width():
    shapes = jax.eval_shape(
        JaxGenerator(jc.GeneratorConfig()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 256, 256, 3)))
    flat = traverse_util.flatten_dict(shapes["params"], sep="/")
    want = {k for k in flat if jax_transfer._is_frozen_path(
        [jax.tree_util.DictKey(p) for p in k.split("/")])}
    gen = ResNetGenerator(pc.GeneratorConfig(), 3, 3, device="meta")
    frozen = {flax_key(k): p.numel() for k, p in gen.named_parameters()
              if transfer.is_frozen(k)}
    assert set(frozen) == want and len(want) == 16
    assert sum(frozen.values()) == 5_687_232
    assert sum(p.numel() for p in gen.parameters()) == 11_383_427
    # The quirk the port copies: every residual block's first conv is in
    # the set, the stem's norm is not.
    assert "ResidualBlock_8/Conv_0/kernel" in frozen
    assert "InstanceNorm_0/scale" not in frozen


def test_apply_freeze_zeroes_exactly_the_encoder():
    w = np.ones(BATCH, np.float32)
    grads, _ = make_grad_fn(CONFIG, BATCH)(
        create_state(CONFIG, 0, device="cpu"), *_inputs(w))
    masked = transfer.apply_freeze(grads)
    for i, (before, after) in enumerate(zip(grads, masked)):
        for k, g in before.items():
            if i < 2 and transfer.is_frozen(k):
                assert torch.equal(after[k], torch.zeros_like(g)), k
            else:
                assert after[k] is g, k
    assert transfer.frozen_leaves(masked[0])
    assert not any(transfer.is_frozen(k) and torch.count_nonzero(g)
                   for tree in masked[:2] for k, g in tree.items())


def _frozen(config, init_from="parent"):
    return dataclasses.replace(config, train=dataclasses.replace(
        config.train, init_from=init_from, transfer_mode="encoder_freeze"),
        obs=dataclasses.replace(config.obs, health=True))


def test_a_frozen_step_keeps_the_encoder_bitwise_as_jaxs_does():
    w = np.ones(BATCH, np.float32)
    j = _jax()
    jax_state, want = jax.jit(jax_train_step(_frozen(JAX_CONFIG), BATCH))(
        j["signal"], j["x"], j["y"], w)
    state = state_from_flax(_numpy_state(j["signal"]), CONFIG, device="cpu")
    before = [{k: p.detach().clone() for k, p in net.named_parameters()}
              for net in state.networks]
    config = _frozen(CONFIG)
    assert transfer.freeze_active(config)
    for grad_impl in ("combined", "fusedprop"):
        config = dataclasses.replace(config, train=dataclasses.replace(
            config.train, grad_impl=grad_impl))
        state, got = make_train_step(config, BATCH)(state, *_inputs(w))
        assert set(got) == set(want)
        assert got["health/gnorm_enc_frozen"].item() == 0.0
        assert got["health/upd_ratio_enc_frozen"].item() == 0.0
    assert float(want["health/gnorm_enc_frozen"]) == 0.0
    for i, net in enumerate(state.networks):
        for k, p in net.named_parameters():
            unchanged = torch.equal(p.detach(), before[i][k])
            assert unchanged == (i < 2 and transfer.is_frozen(k)), (i, k)
    # Every parameter has its Adam state, the frozen ones all zeros, so a
    # slot interchanges with an unfrozen run's.
    for net, opt in zip(state.networks[:2], state.optimizers[:2]):
        for k, p in net.named_parameters():
            moments = opt.state[p]
            assert int(moments["step"]) == 2
            if transfer.is_frozen(k):
                assert not torch.count_nonzero(moments["exp_avg"])


# -- parent restore and domain checks ---------------------------------------

def test_restore_parent_moves_weights_only(tmp_path):
    parent = create_state(CONFIG, 3, device="cpu")
    w = np.ones(BATCH, np.float32)
    parent, _ = make_train_step(CONFIG, BATCH)(parent, *_inputs(w))
    Checkpointer(str(tmp_path / "parent"), keep=2).save(
        parent, 4, meta=save_meta(CONFIG))
    config = _frozen(dataclasses.replace(
        CONFIG, data=pc.DataConfig(domain="monet2photo")),
        str(tmp_path / "parent"))
    child, prov = transfer.restore_parent(
        config, create_state(config, 0, device="cpu"))
    assert child.step == 0
    for net, opt, theirs in zip(child.networks, child.optimizers,
                                parent.networks):
        assert not opt.state
        for (k, p), q in zip(net.named_parameters(), theirs.parameters()):
            assert torch.equal(p.detach(), q.detach()), k
    assert prov == {"parent_ckpt": str(tmp_path / "parent"),
                    "parent_epoch": 4, "parent_domain": "horse2zebra",
                    "transfer_mode": "encoder_freeze",
                    "domain": "monet2photo"}
    with pytest.raises(registry.DomainError, match="strict_domain"):
        transfer.restore_parent(
            dataclasses.replace(config, train=dataclasses.replace(
                config.train, strict_domain=True)),
            create_state(config, 0, device="cpu"))


def test_restore_parent_refusals(tmp_path):
    config = _frozen(CONFIG, str(tmp_path / "nothing"))
    with pytest.raises(transfer.TransferError, match="no checkpoint slots"):
        transfer.restore_parent(config, create_state(config, 0, device="cpu"))
    Checkpointer(str(tmp_path / "wide"), keep=1).save(
        create_state(CONFIG, 0, device="cpu"), 0)
    narrow = dataclasses.replace(_frozen(CONFIG, str(tmp_path / "wide")),
                                 model=dataclasses.replace(
                                     CONFIG.model,
                                     generator=pc.GeneratorConfig(
                                         filters=2, num_residual_blocks=1)))
    with pytest.raises(transfer.TransferError, match="architectures"):
        transfer.restore_parent(narrow, create_state(narrow, 0, device="cpu"))
    with pytest.raises(transfer.TransferError, match="transfer mode"):
        transfer.validate_mode("freeze_encoder")


def test_domain_checks_are_jaxs():
    assert transfer.sidecar_domain(None) == jax_transfer.sidecar_domain(None)
    assert transfer.sidecar_domain({"model": {}}) == "horse2zebra"
    assert transfer.sidecar_domain({"domain": "maps"}) == "maps"
    echoed = []
    assert not transfer.check_domain_compat({"domain": "maps"}, "facades",
                                            strict=False, echo=echoed.append)
    assert "does not match" in echoed[0]
    assert transfer.check_domain_compat({}, "horse2zebra", strict=True)
    errors = []
    for module in (transfer, jax_transfer):
        with pytest.raises(ValueError) as e:
            module.check_domain_compat({"domain": "maps"}, "facades",
                                       strict=True, context="resume")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert transfer.spec_summary(_frozen(CONFIG)) == {
        "init_from": "parent", "transfer_mode": "encoder_freeze",
        "frozen_modules": ["Conv_0", "Downsample_0", "Downsample_1"]}


# -- the CLI -----------------------------------------------------------------

def _registry_file(tmp_path):
    path = str(tmp_path / "domains.json")
    with open(path, "w") as f:
        json.dump({"domains": [{"key": "drill_pair", "source": "synthetic",
                                "synthetic_train_size": 3,
                                "synthetic_test_size": 2}]}, f)
    return path


def test_strict_domain_refuses_a_resume_from_another_domain(tmp_path, capsys):
    out = str(tmp_path / "run")
    port_main.main(["--output_dir", out, "--epochs", "1"] + ARGS)
    assert Checkpointer(out).read_meta()["domain"] == "horse2zebra"
    other = ["--domain", "drill_pair", "--domain_registry",
             _registry_file(tmp_path)]
    with pytest.raises(SystemExit, match="strict_domain"):
        port_main.main(["--output_dir", out, "--epochs", "2",
                        "--strict_domain"] + ARGS + other)
    assert [e for e, _ in Checkpointer(out, keep=2).slots()] == [0]
    capsys.readouterr()
    port_main.main(["--output_dir", out, "--epochs", "2"] + ARGS + other)
    printed = capsys.readouterr().out
    assert "WARNING: resume: checkpoint domain 'horse2zebra'" in printed
    assert "Resumed from" in printed
    assert Checkpointer(out).read_meta()["domain"] == "drill_pair"


def test_unknown_domain_ends_the_run(tmp_path):
    with pytest.raises(SystemExit, match="unknown domain 'zebra2horse'"):
        port_main.main(["--output_dir", str(tmp_path), "--domain",
                        "zebra2horse"] + ARGS)


def test_transfer_run_with_the_train_steps_options(tmp_path, capsys):
    parent = str(tmp_path / "A")
    port_main.main(["--output_dir", parent, "--epochs", "1"] + ARGS)
    capsys.readouterr()
    child = str(tmp_path / "D")
    flags = ["--domain", "drill_pair", "--domain_registry",
             _registry_file(tmp_path), "--init_from", parent, "--transfer",
             "encoder_freeze", "--grad_impl", "fusedprop", "--grad_accum",
             "2"]
    port_main.main(["--output_dir", child, "--epochs", "1"] + ARGS + flags)
    printed = capsys.readouterr().out
    assert "global batch size: 4 (2x accumulated)" in printed
    assert "transfer init: encoder_freeze from" in printed
    assert "grad-norm G/F/dX/dY: " in printed
    meta = Checkpointer(child).read_meta()
    assert meta["domain"] == "drill_pair"
    assert meta["transfer"] == {
        "parent_ckpt": parent, "parent_epoch": 0,
        "parent_domain": "horse2zebra", "transfer_mode": "encoder_freeze",
        "domain": "drill_pair"}
    scalars = port_summary.read_scalars(child)
    assert scalars["health/gnorm_enc_frozen"] == [(0, 0.0)]
    slot_a = Checkpointer(parent).slots()[0][1]
    slot_d = Checkpointer(child).slots()[0][1]
    for net in ("g", "f"):
        a, d = (torch.load(os.path.join(s, f"{net}.pt"), weights_only=True)
                for s in (slot_a, slot_d))
        for k in a:
            assert torch.equal(a[k], d[k]) == transfer.is_frozen(k), (net, k)
    # A second run resumes from its own ring, not from the parent, and
    # keeps the provenance.
    port_main.main(["--output_dir", child, "--epochs", "2"] + ARGS + flags)
    printed = capsys.readouterr().out
    assert "Resumed from" in printed and "transfer init" not in printed
    assert Checkpointer(child, keep=2).read_meta()["transfer"] == meta[
        "transfer"]
