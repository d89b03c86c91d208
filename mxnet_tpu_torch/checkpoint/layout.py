"""On-disk checkpoint layout: step directories, atomic commit, discovery,
retention (copied from the framework-free ``mxnet_tpu/checkpoint/layout.py``
L56-224, so either package finds and commits the other's checkpoints).

A checkpoint directory holds one subdirectory per saved step::

    <dir>/
      step-00000003/
        meta.json            <- manifest, written LAST inside the staging dir
        symbol.json          <- optional graph
        params.nd            <- arg:/aux: params (model.save_params format)
        params.host000-of-002.nd (+ .json index)  <- multi-host shard layout
        optimizer.pkl        <- optimizer payload (checkpoint/state.py)
        rng.pkl              <- the port's generators and numpy's state
        kvserver-000-of-002.pkl ...  <- dist_async server snapshots
      .tmp-step-00000004-*/  <- in-flight write (ignored by discovery)

Commit protocol (the crash-safety contract): every file of a checkpoint
is written into a `.tmp-*` staging directory, `meta.json` is written
last, and the staging directory is renamed onto its final `step-N` name
with ``os.replace``. Renames within one filesystem are atomic, so a kill
at ANY point leaves either the complete previous checkpoint set plus a
junk `.tmp-*` dir (swept by the next writer) or the complete new set —
never a truncated "latest". Discovery (`latest_checkpoint`) only ever
considers directories that contain `meta.json`.

The reference's `prefix-symbol.json` / `prefix-%04d.params` two-file
checkpoints remain readable through `model.load_checkpoint`;
`CheckpointManager.import_legacy` converts them into this layout.
"""
from __future__ import annotations

import errno
import json
import os
import re
import shutil
import tempfile

from ..base import MXNetError

__all__ = ["META_FILE", "PARAMS_FILE", "SYMBOL_FILE", "OPTIMIZER_FILE",
           "RNG_FILE",
           "step_dir_name", "step_path", "parse_step", "list_checkpoints",
           "latest_checkpoint", "latest_step", "read_meta", "begin_write",
           "commit", "discard", "clean_stale", "kv_server_file",
           "list_kv_server_files"]

META_FILE = "meta.json"
PARAMS_FILE = "params.nd"
SYMBOL_FILE = "symbol.json"
OPTIMIZER_FILE = "optimizer.pkl"
RNG_FILE = "rng.pkl"

_STEP_RE = re.compile(r"^step-(\d{8,})$")
_TMP_PREFIX = ".tmp-"
_HOST_PARAMS_RE = re.compile(r"^params\.host(\d+)-of-(\d+)\.nd$")
_KV_SERVER_RE = re.compile(r"^kvserver-(\d+)-of-(\d+)\.pkl$")


def step_dir_name(step):
    if step < 0:
        raise MXNetError("checkpoint step must be >= 0, got %d" % step)
    return "step-%08d" % step


def step_path(directory, step):
    return os.path.join(directory, step_dir_name(step))


def parse_step(name):
    """Step number for a committed-checkpoint dir name, else None."""
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def is_committed(path):
    return os.path.isfile(os.path.join(path, META_FILE))


def list_checkpoints(directory):
    """Sorted [(step, path)] of COMMITTED checkpoints under `directory`.
    In-flight `.tmp-*` staging dirs and step dirs missing their manifest
    (a crash between file writes and commit cannot produce one, but a
    partially-pruned dir can) are excluded."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        step = parse_step(name)
        if step is None:
            continue
        path = os.path.join(directory, name)
        if is_committed(path):
            out.append((step, path))
    out.sort()
    return out


def latest_checkpoint(directory):
    """Path of the highest-step committed checkpoint, or None."""
    ckpts = list_checkpoints(directory)
    return ckpts[-1][1] if ckpts else None


def latest_step(directory):
    ckpts = list_checkpoints(directory)
    return ckpts[-1][0] if ckpts else None


def read_meta(path):
    """Manifest dict of a committed checkpoint directory."""
    with open(os.path.join(path, META_FILE)) as f:
        return json.load(f)


def write_meta(staging_path, meta):
    """Write the manifest INSIDE a staging dir. Callers must write it
    after every payload file — it is the commit marker discovery keys on."""
    data = json.dumps(meta, indent=1, sort_keys=True)
    with open(os.path.join(staging_path, META_FILE), "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def begin_write(directory, step, shared=False):
    """Create and return a staging dir for `step` under `directory`.

    `shared=True` (multi-host saves) uses one DETERMINISTIC staging name
    every process agrees on, so all hosts stage their shard files into
    the same dir and only the coordinator commits it — per-process
    mkdtemp dirs would each hold one host's shards and the last commit
    would win with an incomplete set.

    Known limitation: a shared staging dir orphaned by a WHOLE-JOB kill
    mid-save is reused by the next save of the same step, and a stale
    host file from the dead attempt could satisfy the coordinator's
    await before that host rewrites it. Saves of a given step are
    normally serialized per host by the single writer thread, so this
    needs a job-level kill between two same-step attempts; operators
    restarting after such a kill can clear `.tmp-*-shared` dirs first
    (a generation barrier would need a cross-host rendezvous this
    library deliberately doesn't own)."""
    os.makedirs(directory, exist_ok=True)
    if shared:
        path = os.path.join(directory, "%s%s-shared"
                            % (_TMP_PREFIX, step_dir_name(step)))
        os.makedirs(path, exist_ok=True)
        return path
    return tempfile.mkdtemp(dir=directory,
                            prefix="%s%s-" % (_TMP_PREFIX,
                                              step_dir_name(step)))


def commit(staging_path, directory, step):
    """Atomically publish a staging dir as `step-N`. An existing dir for
    the same step (a re-save) is removed first — its manifest is unlinked
    before the tree so discovery never sees a half-deleted 'committed'
    checkpoint."""
    final = step_path(directory, step)
    if os.path.isdir(final):
        _uncommit_and_remove(final)
    try:
        os.replace(staging_path, final)
    except OSError as e:
        if e.errno not in (errno.ENOTEMPTY, errno.EEXIST):
            raise
        # lost a race with a concurrent writer of the same step; that
        # writer's checkpoint is as good as ours
        shutil.rmtree(staging_path, ignore_errors=True)
    return final


def discard(staging_path):
    shutil.rmtree(staging_path, ignore_errors=True)


def _uncommit_and_remove(path):
    try:
        os.unlink(os.path.join(path, META_FILE))
    except OSError:
        pass  # the manifest may already be gone; rmtree removes the rest
    shutil.rmtree(path, ignore_errors=True)


_SHARED_TMP_RE = re.compile(r"^\.tmp-step-(\d{8,})-shared$")


def clean_stale(directory, active=()):
    """Remove `.tmp-*` staging dirs left by killed writers. `active` is a
    collection of staging paths currently being written (never touched).
    SHARED staging dirs (multi-host) are only swept once their step has
    committed: another host may still be writing its shards into one, and
    this process's `active` set cannot know that."""
    removed = []
    active = {os.path.abspath(p) for p in active}
    try:
        names = os.listdir(directory)
    except OSError:
        return removed
    for name in names:
        if not name.startswith(_TMP_PREFIX):
            continue
        path = os.path.abspath(os.path.join(directory, name))
        if path in active:
            continue
        m = _SHARED_TMP_RE.match(name)
        if m and not is_committed(step_path(directory, int(m.group(1)))):
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def prune(directory, keep_steps):
    """Remove committed checkpoints whose step is not in `keep_steps`."""
    removed = []
    for step, path in list_checkpoints(directory):
        if step not in keep_steps:
            _uncommit_and_remove(path)
            removed.append(step)
    return removed


# -- shard / server file naming --------------------------------------------

def host_params_file(host, num_hosts):
    return "params.host%03d-of-%03d.nd" % (host, num_hosts)


def list_host_params_files(path):
    """Sorted [(host, num_hosts, file path)] of multi-host param shards."""
    out = []
    for name in os.listdir(path):
        m = _HOST_PARAMS_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(path, name)))
    out.sort()
    return out


def kv_server_file(path, server, num_servers):
    return os.path.join(path, "kvserver-%03d-of-%03d.pkl"
                        % (server, num_servers))


def list_kv_server_files(path):
    """Sorted [(server, num_servers, file path)] of dist_async server
    snapshots inside a checkpoint dir."""
    out = []
    try:
        names = os.listdir(path)
    except OSError:
        return out
    for name in names:
        m = _KV_SERVER_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(path, name)))
    out.sort()
    return out
