"""Checkpoint and resume of the PyTorch port
(``gym_po_tpu_torch.utils.checkpoint``), on the CPU: the cases of
tests/test_utils.py (env-state round trip, bit-exact resume of a train
step, ``latest_step``) for PPO and recurrent PPO, and orbax's
keep-the-last-three."""

import os

import pytest
import torch

import gym_po_tpu_torch as gpt_torch
from gym_po_tpu_torch.agents import ppo, ppo_rnn
from gym_po_tpu_torch.utils import latest_step, restore_checkpoint, save_checkpoint


def _fields(state):
    return {k: v for k, v in vars(state).items() if isinstance(v, torch.Tensor)}


def test_env_state_checkpoint_roundtrip(tmp_path):
    env = gpt_torch.make("HansenTaxi-v4", device="cpu")
    _, state = env.reset_vec(torch.Generator().manual_seed(0), 8)
    _, state, *_ = env.step_vec(torch.Generator().manual_seed(1), state,
                                torch.zeros(8, dtype=torch.int64))
    save_checkpoint(str(tmp_path / "ck"), 0, state)
    # reset_vec hands two fields one zeros tensor: each gets its own storage
    _, template = env.reset_vec(torch.Generator().manual_seed(9), 8)
    restored = restore_checkpoint(str(tmp_path / "ck"), template)
    assert restored is template
    for name, value in _fields(state).items():
        assert torch.equal(getattr(restored, name), value), name
    assert (restored.elapsed == 1).all() and not restored.completed.any()


def _resume_case(tmp_path, recurrent):
    env = gpt_torch.make("Taxi-v4", time_limit=5, device="cpu")
    cfg = ppo.PPOConfig(num_envs=8, rollout_steps=4, epochs=1, minibatches=2,
                        hidden=(8,))
    if recurrent:
        init, make_step = ppo_rnn.init_rnn_state, ppo_rnn.make_rnn_train_step
        kw = dict(hidden=8)
    else:
        init, make_step, kw = ppo.init_train_state, ppo.make_train_step, {}
    model, ts = init(env, cfg, torch.Generator().manual_seed(0), **kw)
    step = make_step(env, model, cfg)
    ts1, _ = step(ts)
    save_checkpoint(str(tmp_path / "ck"), 1, ts1)
    ts2a, m_a = step(ts1)  # straight through
    want = {k: v.clone() for k, v in _fields(ts2a).items()}

    model_b, fresh = init(env, cfg, torch.Generator().manual_seed(5), **kw)
    params_b = fresh.params
    ts1r = restore_checkpoint(str(tmp_path / "ck"), fresh)
    assert ts1r.update_idx == 1 and ts1r.params is params_b  # in place
    for p in ppo_rnn.rnn_parameter_list(model_b) if recurrent else \
            ppo.parameter_list(model_b):
        assert p.untyped_storage().data_ptr() == params_b.untyped_storage().data_ptr()
    ts2b, m_b = make_step(env, model_b, cfg)(ts1r)  # resumed
    return want, ts2a, ts2b, m_a, m_b


@pytest.mark.parametrize("recurrent", [False, True], ids=["ppo", "recurrent"])
def test_train_resume_is_exact(tmp_path, recurrent):
    """save -> restore into a fresh state -> step == straight-through step,
    bit for bit: params, Adam's moments, envs, hidden state and the
    generator's state."""
    want, ts2a, ts2b, m_a, m_b = _resume_case(tmp_path, recurrent)
    for name, value in want.items():
        assert torch.equal(getattr(ts2b, name), value), name
    for name in ("count", "mu", "nu"):
        assert torch.equal(getattr(ts2b.opt_state, name),
                           getattr(ts2a.opt_state, name)), name
    for name, value in _fields(ts2a.env_state).items():
        assert torch.equal(getattr(ts2b.env_state, name), value), name
    assert torch.equal(ts2b.generator.get_state(), ts2a.generator.get_state())
    assert ts2b.update_idx == ts2a.update_idx == 2
    assert {k: float(v) for k, v in m_a.items()} == {k: float(v) for k, v in m_b.items()}
    assert latest_step(str(tmp_path / "ck")) == 1


def test_keeps_the_last_three_and_restores_a_step(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, torch.zeros(3))
    env = gpt_torch.make("Taxi-v4", device="cpu")
    _, state = env.reset_vec(torch.Generator().manual_seed(0), 4)
    for step in (2, 5, 9, 11):
        save_checkpoint(d, step, state.replace(s=state.s + step))
    assert sorted(os.listdir(d)) == ["11.pt", "5.pt", "9.pt"]
    assert latest_step(d) == 11
    _, template = env.reset_vec(torch.Generator().manual_seed(1), 4)
    assert torch.equal(restore_checkpoint(d, template, step=5).s, state.s + 5)
    assert torch.equal(restore_checkpoint(d, template).s, state.s + 11)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, template, step=2)
    _, wrong = env.reset_vec(torch.Generator().manual_seed(1), 6)
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(d, wrong)
