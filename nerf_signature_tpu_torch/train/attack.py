"""Watermark attack suites (counterpart of ``nerf_signature_tpu/train/attack.py``):
the named-attack sweep, the epsilon-ball parameter attack and the backbone
finetuning attack.

  * ``attack_sweep``: bit accuracy under each entry of ``utils.attacks.
    ATTACKS``; messages drawn ``--bitacc_batch`` at a time as in
    ``test_bitacc`` (the same seed gives JAX's messages), each rendered once
    an attack (uncompacted, the pre-filter off), attacked and normalised per
    view, and decoded on its own (the decoder's batch statistics per
    message, as in JAX's message-vmapped decode).
  * ``parameter_attack``: the adversary perturbs the trainable tree so that
    renders with a message look like the message-free render of the
    original, by Adam on the image MSE, every leaf clamped to +-epsilon of
    its original after each step.  The gradient reaches the message tables
    only (K1's backward into the effective table, then K9's), or under
    ``--copyrnerf`` the colour MLP; the decoder takes none, so it stays
    bit-identical.
  * ``finetune_attack``: the adversary re-fits the backbone (its hash table,
    or with ``full_backbone`` every leaf) to the pseudo-GT of the train
    views with the all-ones message active, through the trainable tree it
    finds (the message tables or the CopyRNeRF MLP, frozen).  The table's gradient is K1's
    backward into the 16-level backbone table; with ``full_backbone`` the
    MLP weights' is K4's full backward.  The field's buffers (the gather
    table, the packed weights) are rebuilt from the trained leaves every
    step.

Each attack is an object with a ``step`` (``ParameterAttack``,
``FinetuneAttack``) and a function of JAX's signature that runs it.
Randomness is explicit: the parameter attack's messages come from
``np.random.default_rng(0)`` (JAX's stream), the sweep's attack draws from
the model's ``torch.Generator``.
"""

import dataclasses
import time

import numpy as np
import torch

from ..models.hidden import hidden_decoder_apply, normalize_img
from ..models.watermark import wtmk_field, wtmk_field_params
from ..render.renderer import render_rays_occ
from ..utils.attacks import ATTACKS, attack_draws
from .metrics import BitAccMeter
from .trainer_wtmk import _per_view, _render_blocks, _tree_map, trainable_leaves, view_batch_shape


def attack_decode(decoder, wcfg, blocks, attack, draws):
    """One message's blocks [D, bh, bw, V*3] -> attacked and normalised per
    view -> decoded [D, 1]; ``draws`` at ``view_batch_shape``."""
    return hidden_decoder_apply(
        decoder, wcfg.decoder, _per_view(lambda x: normalize_img(ATTACKS[attack](x, draws)),
                                         blocks))


@torch.no_grad()
def attack_sweep(trainer, loader, attacks=None, n_test=50, batch=None):
    """Bit accuracy under each named image attack: {name: bit_acc}.
    ``loader``: a 'test'-mode watermark provider."""
    attacks = attacks or list(ATTACKS)
    m = trainer.model
    batch = batch or getattr(getattr(trainer, "opt", None), "bitacc_batch", None) or 8
    ro_b, rd_b = trainer._device_rays(next(iter(loader))["watermark"])
    shape = view_batch_shape(ro_b.shape)
    rc = trainer._rc_eval()
    results = {}
    t0 = time.time()
    next_report = 60.0
    for attack in attacks:
        meter = BitAccMeter()
        done = 0
        while done < n_test:
            if time.time() - t0 >= next_report:
                next_report = time.time() - t0 + 60.0
                trainer.log(f"[attack_sweep] {attack}: {done}/{n_test} messages "
                            f"({time.time() - t0:.0f}s)")
            use = min(batch, n_test - done)
            messages = [trainer.random_message() for _ in range(batch)]  # JAX's draws
            for message in messages[:use]:
                bits = torch.as_tensor(message, device=m.device)
                fp = wtmk_field_params(m.backbone, m.trainable, m.wcfg, bits)
                blocks = _render_blocks(fp, m.occ.occupancy, ro_b, rd_b, m.wcfg, rc,
                                        m.infer_budget)
                draws = attack_draws(attack, shape, m.generator, m.device)
                decoded = attack_decode(m.trainable["decoder"], m.wcfg, blocks, attack, draws)
                meter.update(decoded.cpu().numpy().reshape(-1), message)
            done += use
        results[attack] = meter.measure()
        trainer.log(f"[attack_sweep] {attack:16s} bit_acc={results[attack]:.4f}")
    return results


def _content(data, num_rays, device):
    """The first ``num_rays`` content rays of a train batch and their
    pseudo-GT pixels (None where the batch has none), [n, 3] each."""
    ct = data["content"] if "content" in data else data
    t = lambda k: torch.as_tensor(np.asarray(ct[k], np.float32), device=device).reshape(
        -1, 3)[:num_rays].contiguous()
    return t("rays_o"), t("rays_d"), t("images") if "images" in ct else None


def _render_mse(fp, wcfg, grid, rays_o, rays_d, target, rc, budget, plain):
    out = render_rays_occ(lambda x, d: wtmk_field(fp, wcfg, x, d, plain=plain), grid, rays_o,
                          rays_d, rc, budget=budget, bg_color=1.0, plain=plain)
    return torch.mean((out["image"] - target) ** 2)


def param_attack_loss(backbone, tr, grid, rays_o, rays_d, target, message, wcfg, rc, budget,
                      plain=False):
    """The parameter attack's objective: the image MSE of the render with
    ``message`` through the trainable tree ``tr`` against ``target``."""
    fp = wtmk_field_params(backbone, tr, wcfg, message, plain)
    return _render_mse(fp, wcfg, grid, rays_o, rays_d, target, rc, budget, plain)


def finetune_attack_loss(backbone, train_part, tr, grid, rays_o, rays_d, target, wcfg, rc,
                         budget, plain=False):
    """The finetuning attack's objective: the image MSE, with the all-ones
    message, of the backbone with ``train_part``'s leaves swapped in."""
    ones = torch.ones(wcfg.message_dim, dtype=torch.int32, device=rays_o.device)
    fp = wtmk_field_params(dict(backbone, **train_part), tr, wcfg, ones, plain)
    return _render_mse(fp, wcfg, grid, rays_o, rays_d, target, rc, budget, plain)


def _adam(leaves, lr):
    """``optax.adam(lr)``: betas 0.9 / 0.999, eps 1e-8."""
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def adam_clamp_step(optimizer, leaves, orig_leaves, epsilon):
    """One Adam step, then every leaf clamped to +-epsilon of its original
    (a leaf with no gradient is not stepped, and its clamp is a no-op)."""
    optimizer.step()
    for p, o in zip(leaves, orig_leaves):
        p.clamp_(min=o - epsilon, max=o + epsilon)


class ParameterAttack:
    """The epsilon-ball attack's state on ``trainer.model``: a copy of the
    trainable tree (``attacked``; the model's own is the original and is
    never written), its Adam, the content rays of the loader's first batch
    and the target, the message-free render of the original at the
    inference budget.  ``step(message)`` renders at the train budget."""

    def __init__(self, trainer, loader, epsilon=1e-3, lr=1e-3, num_rays=4096):
        m = self.model = trainer.model
        self.epsilon = epsilon
        self.orig_leaves = trainable_leaves(m.trainable)
        self.attacked = _tree_map(lambda t: t.detach().clone().requires_grad_(True), m.trainable)
        self.leaves = trainable_leaves(self.attacked)
        self.optimizer = _adam(self.leaves, lr)
        self.rays_o, self.rays_d, _ = _content(next(iter(loader)), num_rays, m.device)
        self.rc = dataclasses.replace(m.rc, t_cull=0.0)
        with torch.no_grad():
            fp = wtmk_field_params(m.backbone, m.trainable, m.wcfg, None)
            self.target = render_rays_occ(lambda x, d: wtmk_field(fp, m.wcfg, x, d),
                                          m.occ.occupancy, self.rays_o, self.rays_d, self.rc,
                                          budget=m.infer_budget, bg_color=1.0)["image"]

    def loss(self, message, plain=False):
        m = self.model
        return param_attack_loss(m.backbone, self.attacked, m.occ.occupancy, self.rays_o,
                                 self.rays_d, self.target, message, m.wcfg, self.rc,
                                 m.train_budget, plain)

    def step(self, message):
        loss = self.loss(torch.as_tensor(np.asarray(message, np.int32), device=self.model.device))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        adam_clamp_step(self.optimizer, self.leaves, self.orig_leaves, self.epsilon)
        return loss.detach()

    def result(self):
        return _tree_map(lambda t: t.detach(), self.attacked)


def parameter_attack(trainer, loader, epsilon=1e-3, steps=100, lr=1e-3, num_rays=4096):
    """Epsilon-ball finetuning attack on the watermarked model; returns the
    attacked trainable tree (the caller re-runs ``test_bitacc`` with it)."""
    atk = ParameterAttack(trainer, loader, epsilon, lr, num_rays)
    rng = np.random.default_rng(0)
    loss = float("nan")
    for _ in range(steps):
        loss = atk.step(rng.integers(0, 2, atk.model.wcfg.message_dim).astype(np.int32))
    trainer.log(f"[parameter_attack] eps={epsilon} steps={steps} "
                f"final adv loss={float(loss):.6f}")
    return atk.result()


def _leaves(tree):
    """The tensors of a backbone sub-tree (a tensor or a list of them)."""
    return [v for t in tree.values() for v in (t if isinstance(t, list) else [t])]


class FinetuneAttack:
    """The finetuning attack's state on ``trainer.model``: copies of the
    trained backbone leaves (``train_part``: the hash table, or with
    ``full_backbone`` every leaf; the model's backbone is never written)
    and their Adam.  ``step(data)`` fits a train batch's content rays to
    its pseudo-GT at the inference budget (the pseudo-GT's)."""

    def __init__(self, trainer, lr=1e-3, num_rays=4096, full_backbone=False):
        m = self.model = trainer.model
        self.num_rays = num_rays
        keys = list(m.backbone) if full_backbone else ["hash_table"]
        self.train_part = {k: _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                        m.backbone[k]) for k in keys}
        self.optimizer = _adam(_leaves(self.train_part), lr)
        self.tr = _tree_map(lambda t: t.detach(), m.trainable)  # no gradient
        self.rc = dataclasses.replace(m.rc, t_cull=0.0)

    def loss(self, rays_o, rays_d, target, plain=False):
        m = self.model
        return finetune_attack_loss(m.backbone, self.train_part, self.tr, m.occ.occupancy,
                                    rays_o, rays_d, target, m.wcfg, self.rc, m.infer_budget,
                                    plain)

    def step(self, data):
        loss = self.loss(*_content(data, self.num_rays, self.model.device))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def result(self):
        return dict(self.model.backbone, **_tree_map(lambda t: t.detach(), self.train_part))


def finetune_attack(trainer, loader, steps=100, lr=1e-3, num_rays=4096, full_backbone=False):
    """Backbone finetuning attack, cycling the (re-iterable) train loader;
    returns the attacked backbone (the caller re-runs ``test_bitacc``)."""
    atk = FinetuneAttack(trainer, lr, num_rays, full_backbone)
    loss = float("nan")
    done = 0
    while done < steps:
        before = done
        for data in loader:
            if done >= steps:
                break
            loss = atk.step(data)
            done += 1
        if done == before:
            raise ValueError("finetune_attack loader yielded no batches — pass a re-iterable "
                             "loader, not a one-shot generator")
    trainer.log(f"[finetune_attack] steps={steps} lr={lr} full_backbone={full_backbone} "
                f"final adv loss={float(loss):.6f}")
    return atk.result()
