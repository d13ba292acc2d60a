"""Long-term feature bank (LFB): storage, window gathering and generation.

Port of ``tubelet_transformer_tpu/eval/lfb.py``. ``FeatureBank`` and
``BankAttachDataset`` are the port's copies of the JAX package's, on numpy
alone: per keyframe the final-layer query features of the confident actors
(P(actor) over a threshold, padded to a fixed slot count), saved as a plain
``.npz`` keyed by "vid,ssss" AVA keys in the same layout; ``window`` gathers
the keyframes of +-``half_window`` seconds around a key into a fixed-shape
(L_mem, D) memory with a True-is-pad mask.

``generate_bank`` runs the model's ``generate_lfb`` mode over a loader, the
eval build under ``torch.inference_mode`` with the validation's
``device_preprocess``. Under torchrun (``MESH.DATA``, ``MESH.MODEL``) each
process runs its data shard and every batch's features, actor
probabilities and keyframe indices are gathered over the data shards, as
the JAX version's ``gather_global`` does, so that every process fills the
full bank.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class FeatureBank:
    def __init__(self, feat_dim: int, slots_per_frame: int = 5):
        self.feat_dim = feat_dim
        self.slots = slots_per_frame
        self._bank: Dict[str, np.ndarray] = {}    # key -> (slots, D)
        self._valid: Dict[str, np.ndarray] = {}   # key -> (slots,) bool

    def __len__(self) -> int:
        return len(self._bank)

    def add(self, key: str, features: np.ndarray,
            actor_prob: np.ndarray, threshold: float = 0.8) -> None:
        """features (Q, D); actor_prob (Q,). Keeps top slots by probability,
        validity-gated at the threshold."""
        order = np.argsort(-actor_prob)[: self.slots]
        feats = np.zeros((self.slots, self.feat_dim), np.float32)
        valid = np.zeros((self.slots,), bool)
        n = len(order)
        feats[:n] = features[order]
        valid[:n] = actor_prob[order] > threshold
        self._bank[key] = feats
        self._valid[key] = valid

    def window(self, vid: str, second: int, half_window: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Gather features of ``vid`` seconds [s-hw, s+hw] (excluding s)
        -> ((2*hw) * slots, D) memory + True-means-PAD mask (fixed shape)."""
        secs = [s for s in range(second - half_window, second + half_window + 1)
                if s != second]
        mem = np.zeros((len(secs) * self.slots, self.feat_dim), np.float32)
        pad = np.ones((len(secs) * self.slots,), bool)
        for i, s in enumerate(secs):
            key = f"{vid},{s:04d}"
            if key in self._bank:
                sl = slice(i * self.slots, (i + 1) * self.slots)
                mem[sl] = self._bank[key]
                pad[sl] = ~self._valid[key]
        return mem, pad

    def save(self, path: str) -> None:
        keys = list(self._bank)
        np.savez_compressed(
            path, keys=np.array(keys),
            feats=np.stack([self._bank[k] for k in keys]) if keys
            else np.zeros((0, self.slots, self.feat_dim), np.float32),
            valid=np.stack([self._valid[k] for k in keys]) if keys
            else np.zeros((0, self.slots), bool))

    @classmethod
    def load(cls, path: str) -> "FeatureBank":
        data = np.load(path, allow_pickle=False)
        feats = data["feats"]
        bank = cls(feat_dim=feats.shape[-1] if feats.size else 256,
                   slots_per_frame=feats.shape[1] if feats.size else 5)
        for i, k in enumerate(data["keys"]):
            bank._bank[str(k)] = feats[i]
            bank._valid[str(k)] = data["valid"][i]
        return bank


class BankAttachDataset:
    """Dataset wrapper that ships a long-term memory window with each
    sample: a fixed-shape ``(L_mem, D)`` memory and its True-is-pad mask,
    gathered from a :class:`FeatureBank` around the keyframe the base
    dataset returned (the reference's USE_LFB collate variants,
    utils/misc.py:284-308)."""

    def __init__(self, base, bank: FeatureBank, half_window: int = 10):
        if not hasattr(base, "keys"):
            raise ValueError(
                "BankAttachDataset needs a dataset with 'vid,ssss' keys")
        self.base = base
        self.bank = bank
        self.half_window = half_window

    def __len__(self) -> int:
        return len(self.base)

    def __getattr__(self, name):
        return getattr(self.base, name)

    def get(self, index: int, rng) -> Dict:
        sample = self.base.get(index, rng)
        # the base dataset resamples another index on empty targets
        # (data/ava.py); the window follows the keyframe it returned
        real_index = int(sample.get("key_idx", index))
        vid, sec = self.base.keys[real_index].rsplit(",", 1)
        mem, pad = self.bank.window(vid, int(sec), self.half_window)
        sample["lfb_features"] = mem
        sample["lfb_mask"] = pad
        return sample


def generate_bank(cfg, model, loader, threshold: float = 0.8, mesh=None
                  ) -> FeatureBank:
    """Run ``model`` (the eval build of a ``generate_lfb`` config) over
    ``loader`` and fill a bank: each sample's query features under its
    keyframe's key, with its actor probabilities (softmax of the actorness
    logits, class 1). One device-to-host copy per batch. With ``mesh``
    (``parallel.mesh.Mesh``; ``loader`` this process's data shard) each
    batch's features, probabilities and keyframe indices of every data
    shard, in ONE host collective (``gather_global_tree``, each shard from
    its first rank of MESH.MODEL x MESH.PIPE): every process fills the full bank."""
    import torch

    from tubelet_transformer_tpu_torch.data.device_preprocess import (
        device_preprocess)
    from tubelet_transformer_tpu_torch.parallel import mesh as mesh_lib

    device = next(model.parameters()).device
    bank = FeatureBank(feat_dim=cfg.model.d_model,
                       slots_per_frame=min(cfg.model.query_num, 5))
    dataset = loader.dataset
    model.eval()
    for batch in loader:
        with torch.inference_mode():
            pad = torch.as_tensor(batch["pad_mask"], device=device)
            out = model(device_preprocess(
                torch.as_tensor(batch["clips"], device=device),
                dtype=model.dtype, pad_mask=pad), pad)
            prob = out["pred_logits_b"].float().softmax(dim=-1)[..., 1]
            feats = out["lfb_features"].float()
            flat = torch.cat([feats.reshape(-1), prob.reshape(-1)]).cpu()
        feats, prob = (a.numpy().reshape(t.shape) for a, t in zip(
            flat.split([feats.numel(), prob.numel()]), (feats, prob)))
        key_idx = np.asarray(batch["key_idx"])
        if mesh is not None:
            g = mesh_lib.gather_global_tree(
                {"feats": feats, "prob": prob, "key_idx": key_idx},
                mesh.model * mesh.pipe)
            feats, prob, key_idx = g["feats"], g["prob"], g["key_idx"]
        for i in range(feats.shape[0]):
            idx = int(key_idx[i])
            key = dataset.keys[idx] if hasattr(dataset, "keys") else str(idx)
            bank.add(key, feats[i], prob[i], threshold)
    return bank
