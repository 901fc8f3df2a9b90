"""features.f32 dataset — memmap of 98-float records
[65 features | 32 gain targets | 1 vad]  (train_rnnoise.py:65-84).

A copy of ``rnnoise_tpu/training/data.py`` (numpy only), kept here so the
port never imports the JAX package."""

from __future__ import annotations

import numpy as np

RECORD_DIM = 98
N_FEATURES = 65
N_GAINS = 32


class RNNoiseDataset:
    def __init__(self, features_file: str, sequence_length: int = 2000):
        self.sequence_length = sequence_length
        data = np.memmap(features_file, dtype="float32", mode="r")
        dim = RECORD_DIM
        self.nb_sequences = data.shape[0] // sequence_length // dim
        data = data[: self.nb_sequences * sequence_length * dim]
        self.data = np.reshape(data,
                               (self.nb_sequences, sequence_length, dim))

    def __len__(self):
        return self.nb_sequences

    def __getitem__(self, index):
        rec = self.data[index]
        return (rec[:, :N_FEATURES].copy(),
                rec[:, N_FEATURES:-1].copy(),
                rec[:, -1:].copy())

    def batch(self, indices):
        rec = self.data[np.asarray(indices)]
        return (np.ascontiguousarray(rec[:, :, :N_FEATURES]),
                np.ascontiguousarray(rec[:, :, N_FEATURES:-1]),
                np.ascontiguousarray(rec[:, :, -1:]))
