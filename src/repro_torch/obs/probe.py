"""In-sim telemetry probes: time-resolved rings the flit step fills.

With ``SimConfig.telemetry`` on, the lane-batched state carries five
int32 ring buffers over ``tel_slots`` recording slots, each covering
``tel_epoch`` cycles (0 = auto: ``ceil(cycles / tel_slots)``, so one
pass fills the ring once).  A cycle lands in slot
``(cycle // epoch) % tel_slots``; runs longer than the ring wrap and
accumulate into the old slots (``tel_cycles`` normalises):

* ``tel_chan`` (L, S, C) — flits forwarded on each channel;
* ``tel_counts`` (L, S, 4) — packets offered, accepted into a source
  queue, shed at a full queue, and delivered (tail ejections);
* ``tel_cycles`` (L, S) — cycles recorded into each slot;
* ``tel_lat`` (L, S, lat_bins) — every tail ejection's latency, binned
  like the aggregate ``lat_hist``;
* ``tel_qocc`` (L, S, tel_occ_bins) — each cycle one count into the bin
  of the network's total source-queue fill fraction.

The updates read values the cycle computes anyway and write only these
rings; they draw no random bits, so the core state is bit-identical with
the probes on or off.  With ``telemetry=False`` the state has none of
these keys.

:class:`Telemetry` is the host view: lane-major numpy arrays from a
fetched state, with trajectory accessors and npz persistence.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

__all__ = ["TEL_KEYS", "TEL_COUNT_FIELDS", "resolved_epoch",
           "telemetry_state", "Telemetry"]

# Telemetry state keys, in the order fresh_state creates them.
TEL_KEYS = ("tel_chan", "tel_counts", "tel_cycles", "tel_lat", "tel_qocc")
# Columns of tel_counts.
TEL_COUNT_FIELDS = ("offered", "accepted", "shed", "delivered")


def resolved_epoch(cfg) -> int:
    """Recording-slot length in cycles (0 when telemetry is off): a pure
    function of the config, so every path and every chunking of one run
    agree on the slot boundaries."""
    if not cfg.telemetry:
        return 0
    if int(cfg.tel_epoch) > 0:
        return int(cfg.tel_epoch)
    return max(1, -(-int(cfg.cycles) // int(cfg.tel_slots)))


def telemetry_state(meta: dict, cfg, num_lanes: int, device) -> dict:
    """Fresh zeroed rings for ``num_lanes`` lanes on ``device`` ({} when
    telemetry is off)."""
    if not cfg.telemetry:
        return {}
    s = int(cfg.tel_slots)

    def z(*shape):
        return torch.zeros((num_lanes,) + shape, dtype=torch.int32,
                           device=device)

    return dict(tel_chan=z(s, meta["C"]),
                tel_counts=z(s, len(TEL_COUNT_FIELDS)),
                tel_cycles=z(s), tel_lat=z(s, cfg.lat_bins),
                tel_qocc=z(s, cfg.tel_occ_bins))


@dataclasses.dataclass
class Telemetry:
    """Host-side telemetry of one cell (all lanes).

    Lane-major arrays: ``chan`` (lanes, slots, C), ``counts`` (lanes,
    slots, 4) in :data:`TEL_COUNT_FIELDS` order, ``cycles`` (lanes,
    slots), ``lat`` (lanes, slots, lat_bins), ``qocc`` (lanes, slots,
    occ_bins).  ``bw`` (slots, C) is the channel bandwidth in effect at
    each slot's end, attached by the caller that knows the fault
    timeline; None means it was never attached.
    """

    epoch_len: int
    lat_bin_width: int
    chan: np.ndarray
    counts: np.ndarray
    cycles: np.ndarray
    lat: np.ndarray
    qocc: np.ndarray
    bw: np.ndarray | None = None

    @classmethod
    def from_state(cls, host_state: dict, cfg) -> "Telemetry | None":
        """From a host (numpy) state with a leading lane axis; None when
        the state carries no telemetry."""
        if "tel_chan" not in host_state:
            return None
        a = {k: np.asarray(host_state[k]) for k in TEL_KEYS}
        if a["tel_chan"].ndim == 2:        # one lane: add the axis
            a = {k: v[None] for k, v in a.items()}
        return cls(epoch_len=resolved_epoch(cfg),
                   lat_bin_width=int(cfg.lat_bin_width),
                   chan=a["tel_chan"].astype(np.int64),
                   counts=a["tel_counts"].astype(np.int64),
                   cycles=a["tel_cycles"].astype(np.int64),
                   lat=a["tel_lat"].astype(np.int64),
                   qocc=a["tel_qocc"].astype(np.int64))

    def with_bw(self, bw_slots: np.ndarray) -> "Telemetry":
        return dataclasses.replace(self, bw=np.asarray(bw_slots, np.float64))

    @property
    def num_lanes(self) -> int:
        return int(self.chan.shape[0])

    @property
    def num_slots(self) -> int:
        return int(self.chan.shape[1])

    def active_slots(self) -> np.ndarray:
        """Slots that recorded at least one cycle (every lane steps every
        cycle, so lane 0 speaks for all)."""
        return np.nonzero(self.cycles[0] > 0)[0]

    def slot_starts(self) -> np.ndarray:
        """First absolute cycle of each slot (ring wrap ignored)."""
        return np.arange(self.num_slots, dtype=np.int64) * self.epoch_len

    def link_load(self) -> np.ndarray:
        """(lanes, slots, C) flits a cycle on each channel, over the
        slot's bandwidth when attached (dead links give 0, as
        ``postprocess`` takes them)."""
        cyc = np.maximum(self.cycles, 1)[:, :, None].astype(np.float64)
        load = self.chan.astype(np.float64) / cyc
        if self.bw is not None:
            bw = self.bw[None]
            load = np.where(bw > 0, load / np.where(bw > 0, bw, 1.0), 0.0)
        return load

    def peak_link_load(self) -> np.ndarray:
        """(lanes, slots) the largest normalised channel load a slot."""
        load = self.link_load()
        return load.max(axis=2) if load.shape[2] else np.zeros(
            load.shape[:2])

    def latency_percentile(self, q: float) -> np.ndarray:
        """(lanes, slots) latency q-quantile a slot, from its histogram
        (the aggregate percentiles' estimator; an empty slot gives 0)."""
        from ..noc.sim import hist_percentile
        out = np.zeros((self.num_lanes, self.num_slots))
        for i in range(self.num_lanes):
            for s in range(self.num_slots):
                out[i, s] = hist_percentile(self.lat[i, s],
                                            self.lat_bin_width, q)
        return out

    def occupancy_mean(self) -> np.ndarray:
        """(lanes, slots) mean source-queue fill fraction, from the
        occupancy histograms (bin centres)."""
        nb = self.qocc.shape[2]
        centers = (np.arange(nb) + 0.5) / nb
        tot = np.maximum(self.qocc.sum(axis=2), 1).astype(np.float64)
        return (self.qocc @ centers) / tot

    def count(self, field: str) -> np.ndarray:
        """(lanes, slots) one :data:`TEL_COUNT_FIELDS` counter."""
        return self.counts[:, :, TEL_COUNT_FIELDS.index(field)]

    def save(self, path: str) -> None:
        """Write as npz (the metadata as JSON bytes)."""
        meta = {"epoch_len": int(self.epoch_len),
                "lat_bin_width": int(self.lat_bin_width)}
        payload = dict(chan=self.chan, counts=self.counts,
                       cycles=self.cycles, lat=self.lat, qocc=self.qocc)
        if self.bw is not None:
            payload["bw"] = self.bw
        payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                            np.uint8)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "Telemetry":
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
        meta = json.loads(bytes(d.pop("__meta__")).decode())
        return cls(epoch_len=int(meta["epoch_len"]),
                   lat_bin_width=int(meta["lat_bin_width"]),
                   chan=d["chan"], counts=d["counts"], cycles=d["cycles"],
                   lat=d["lat"], qocc=d["qocc"], bw=d.get("bw"))
