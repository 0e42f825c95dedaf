"""Resume state machine: segment-granularity checkpoint/restart.

This is the reference's flagship feature (SURVEY.md §5): it persists
`temp\\args.temp` (the CLI args) and `temp\\video.temp` (a pending-segment
queue consumed front-first, rewritten after every completed segment,
reve-cli/src/main.rs:112-121, 340-343), detects a prior run by the state
file existing (main.rs:43-45), and repairs the queue on restart
(main.rs:142-159): the segment *before* the first pending one is re-queued
because its encode may have died mid-write, and its possibly-torn part file
is deleted.

Differences from the reference (deliberate):
  * One JSON state file with an explicit schema version + atomic
    write-rename, instead of two bincode-ish blobs.
  * Part files are written to `<part>.tmp` and renamed on encoder close, so
    a completed `.mp4` part is always whole — the predecessor re-queue then
    only matters for crashes between "segment popped" and "state rewritten",
    which the same repair rule covers.
  * Cross-platform paths (the reference hardcodes `temp\\` backslashes).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import List, Optional

from reve_tpu_torch.pipeline.planner import Segment

STATE_VERSION = 1
STATE_FILE = "state.json"
PARTS_DIR = "parts"
CALIBRATION_FILE = "int8_calibration.json"
CERT_FILE = "int8_cert.json"
RESOLUTION_FILE = "auto_dtype.json"
OWNER_FILE = "owner.lock"
#: how long the contender that cleared a stale owner lock keeps retrying
#: its creation against empty flock artifacts (Workspace
#: ._acquire_owner_pidfile)
_STEAL_RETRY_S = 1.0


@dataclasses.dataclass
class JobState:
    """Everything needed to resume an interrupted upscale job."""

    input_path: str
    output_path: str
    scale: int
    segment_size: int
    frame_count: int
    fps_num: int
    fps_den: int
    width: int
    height: int
    pending: List[Segment]
    #: the full segment plan (pending + completed).  Needed on resume when
    #: the plan is not derivable from (frame_count, segment_size) — e.g.
    #: scene-aligned boundaries.  None -> uniform plan (re-derived).
    plan: Optional[List[Segment]] = None
    encode: dict = dataclasses.field(default_factory=dict)
    model: str = "realesr-animevideov3"
    #: engine/io settings the job was started with (weights, dtype,
    #: io_backend, denoise...).  A resume restores these instead of
    #: trusting the new command line — the reference persists its whole
    #: Args for the same reason (reve-cli/src/main.rs:112-113).
    opts: dict = dataclasses.field(default_factory=dict)
    version: int = STATE_VERSION

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["pending"] = [s.to_json() for s in self.pending]
        d["plan"] = [s.to_json() for s in self.plan] if self.plan else None
        return d

    @staticmethod
    def from_json(d: dict) -> "JobState":
        if d.get("version") != STATE_VERSION:
            raise ValueError(f"unsupported state version {d.get('version')}")
        d = dict(d)
        d["pending"] = [Segment.from_json(s) for s in d["pending"]]
        if d.get("plan"):
            d["plan"] = [Segment.from_json(s) for s in d["plan"]]
        return JobState(**d)


class Workspace:
    """The temp workspace: state file + completed part files.

    Analog of the reference's `temp/` tree + `rebuild_temp`
    (reve-shared/src/lib.rs:291-312), minus the PNG frame dirs — frames
    never touch disk here.
    """

    def __init__(self, root: str):
        self.root = root
        self.parts_dir = os.path.join(root, PARTS_DIR)
        self.state_path = os.path.join(root, STATE_FILE)
        self._owner_fd: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------

    def create(self, keep_parts: bool = False) -> None:
        """(Re)create the workspace; keep_parts=True preserves completed
        segment files for resume (lib.rs:301-311 semantics).  A fresh
        start (keep_parts=False) also drops the previous job's int8
        calibration, certificate and auto-dtype resolution: they belong
        to the discarded job, and a first-wins claim would otherwise hand
        them to the new one."""
        os.makedirs(self.root, exist_ok=True)
        if not keep_parts and os.path.isdir(self.parts_dir):
            shutil.rmtree(self.parts_dir)
        if not keep_parts:
            for name in (STATE_FILE, CALIBRATION_FILE, CERT_FILE,
                         RESOLUTION_FILE):
                path = os.path.join(self.root, name)
                if os.path.exists(path):
                    os.unlink(path)
        os.makedirs(self.parts_dir, exist_ok=True)

    def destroy(self) -> None:
        if os.path.isdir(self.root):
            shutil.rmtree(self.root)

    # -- state persistence -------------------------------------------------

    def has_state(self) -> bool:
        """Resume detection: 'does the state file exist' (main.rs:43-45)."""
        return os.path.exists(self.state_path)

    def save(self, state: JobState) -> None:
        """Atomic write: the state file is never observable half-written."""
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".state.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(state.to_json(), f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self) -> JobState:
        with open(self.state_path) as f:
            return JobState.from_json(json.load(f))

    # -- int8 calibration (first-wins, job-scoped) -------------------------

    # -- single-writer owner lock -------------------------------------------

    @property
    def owner_path(self) -> str:
        return os.path.join(self.root, OWNER_FILE)

    def acquire_owner(self) -> bool:
        """Single-writer advisory lock for NON-sharded runs: a second
        concurrent CLI/API/service run on the same workspace would redo
        every pending segment and race the finalize rename (the reference
        has the same hazard on its exe-relative `temp\\`; two instances
        there silently corrupt each other's state).  Multi-writer is the
        lease queue's job (--shard-worker), which skips this lock.

        Kernel `flock` on `owner.lock`: the lock dies with the holding
        process (a crashed owner needs no stealing, and there is no
        read-check-delete race between contenders).  The pid inside the
        file is diagnostic only.  Re-acquiring through the same Workspace
        instance succeeds; a second live process gets False.

        Filesystems where flock is UNSUPPORTED (ENOLCK/EOPNOTSUPP on some
        network mounts; no fcntl module off-POSIX) degrade to an O_EXCL
        pid file with dead-pid stealing (_acquire_owner_pidfile) instead
        of crashing — weaker (pid liveness is per-HOST, and an unclean
        kill leaves the file until the next contender steals it), which
        is fine because cross-host coordination is the lease queue's job,
        not this lock's (docs/ARCHITECTURE.md, "Shared-filesystem
        requirements")."""
        if self._owner_fd is not None:
            return True
        os.makedirs(self.root, exist_ok=True)
        try:
            import fcntl
        except ImportError:
            return self._acquire_owner_pidfile()
        while True:
            fd = os.open(self.owner_path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                os.close(fd)
                import errno

                if e.errno in (errno.EACCES, errno.EAGAIN):
                    return False  # held by another live process
                # flock itself unsupported here (e.g. ENOLCK on an NFS
                # mount without a lock manager): degrade, don't crash
                return self._acquire_owner_pidfile()
            # the path may have been unlinked+recreated between our open
            # and the flock (a releasing owner): a lock on an orphaned
            # inode excludes nobody — verify we locked the live file
            try:
                live = os.stat(self.owner_path)
            except FileNotFoundError:
                os.close(fd)
                continue
            if os.fstat(fd).st_ino != live.st_ino:
                os.close(fd)
                continue
            os.ftruncate(fd, 0)
            os.write(fd, json.dumps({"pid": os.getpid()}).encode())
            self._owner_fd = fd
            return True

    def _acquire_owner_pidfile(self) -> bool:
        """Owner-lock fallback for filesystems without flock.

        Creation is ATOMIC (pid json written to a tmp file, hardlinked
        into place) so the pid file is never observably empty or torn: an
        empty `owner.lock` is definitively a flock-path artifact (the
        O_CREAT that preceded the failed flock — typically our own from
        this very acquire_owner call), not a contender mid-write.

        Stealing (dead recorded pid, or an empty flock artifact) is
        SERIALIZED through an atomic `mkdir` mutex and re-verifies the
        file's content INSIDE the mutex: without this, two contenders
        that both read a dead pid race read-unlink-create and can BOTH
        acquire — one unlinking the other's freshly created live lock
        (the exact double-writer corruption this lock exists to prevent).
        A contender that finds a live owner, or another steal in
        progress, returns False (stay safe).

        The race this guards: a contender whose flock attempt starts
        after a steal's unlink recreates the path, EMPTY, by its
        os.open(O_CREAT), before the stealer links its pid file.  A
        stealer that stopped after two create/steal rounds could then
        give up on a path nobody owns, and so could every contender:
        no winner.  So the contender that cleared the path keeps
        creating, and stealing empty artifacts, while the path is absent
        or empty, for at most _STEAL_RETRY_S (each contender leaves at
        most one artifact per call).

        Residual windows, accepted for a degraded-FS fallback: pid
        liveness is per-HOST (cross-host single-writing is the lease
        queue's job), and on a filesystem ALSO lacking hardlinks creation
        degrades to O_EXCL-then-write whose µs-scale create-to-write gap
        an empty-steal could theoretically hit (the 50 ms stability
        recheck guards it)."""
        import time

        if self._pidfile_create():
            return True
        if not self._pidfile_try_steal():
            return False
        deadline = time.monotonic() + _STEAL_RETRY_S
        while time.monotonic() <= deadline:
            if self._pidfile_create():
                return True
            if self._pidfile_try_steal():
                continue
            # a live owner won, or another contender is stealing an
            # empty artifact (and will create in turn)
            if not self._pidfile_vacant():
                return False
            time.sleep(0.005)
        return False

    def _pidfile_vacant(self) -> bool:
        """owner_path is absent or an empty flock artifact."""
        try:
            return os.path.getsize(self.owner_path) == 0
        except FileNotFoundError:
            return True
        except OSError:
            return False

    def _pidfile_create(self) -> bool:
        """Atomically publish {pid: us} at owner_path; False if a file is
        already there (live or stealable — caller decides)."""
        payload = json.dumps({"pid": os.getpid()}).encode()
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".owner.tmp")
        keep_fd = False
        linkless = False
        try:
            os.write(fd, payload)
            os.fsync(fd)
            try:
                os.link(tmp, self.owner_path)
                # linked into place; keep the tmp fd — same inode
                self._owner_fd = fd
                keep_fd = True
                return True
            except FileExistsError:
                return False
            except OSError:
                linkless = True  # handled below, outside this finally
        finally:
            if not keep_fd:
                try:
                    os.close(fd)
                except OSError:
                    pass
            try:
                os.unlink(tmp)
            except OSError:
                pass
        assert linkless
        # hardlink-less FS: O_EXCL create + immediate write (the
        # documented µs create-to-write window)
        try:
            fd2 = os.open(self.owner_path,
                          os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o644)
        except FileExistsError:
            return False
        os.write(fd2, payload)
        try:
            os.fsync(fd2)
        except OSError:
            pass
        self._owner_fd = fd2
        return True

    def _pidfile_try_steal(self) -> bool:
        """Under the steal mutex: re-verify owner_path is stale (dead pid
        or stably-empty flock artifact) and unlink it.  True = the path
        is now free to (re)create; False = live/unverifiable/locked-out.
        """
        import time

        mutex = self.owner_path + ".steal"
        try:
            st = os.stat(mutex)
            # Same-clock staleness (round-4 ADVICE #2): stamp a probe file
            # on the SAME mount and compare its server-assigned mtime to
            # the mutex's — this fallback runs exactly where client/server
            # clocks can skew (network mounts), and a local-clock
            # comparison could reap a LIVE stealer's mutex.  The probe
            # only exists for the stat; local time.time() is the fallback
            # when the mount refuses the write, with a threshold far above
            # any plausible skew + the sub-second steal critical section.
            probe = f"{mutex}.probe.{os.getpid()}"
            try:
                with open(probe, "w"):
                    pass
                now = os.stat(probe).st_mtime
                os.unlink(probe)
                stale = now - st.st_mtime > 30.0
            except OSError:
                stale = time.time() - st.st_mtime > 300.0
            if stale:
                # a stealer crashed mid-steal; at most one contender's
                # rmdir succeeds, and the re-mkdir below re-arbitrates
                try:
                    os.rmdir(mutex)
                except OSError:
                    pass
        except OSError:
            pass
        try:
            os.mkdir(mutex)
        except OSError:
            return False  # another steal in progress: stay safe
        try:
            try:
                with open(self.owner_path, "rb") as f:
                    body = f.read()
            except FileNotFoundError:
                return True   # freed meanwhile (owner released)
            except OSError:
                return False
            if body == b"":
                # flock-path artifact (creation here is atomic, so no
                # pidfile owner is ever empty).  50 ms stability recheck
                # covers the hardlink-less creator's O_EXCL window.
                time.sleep(0.05)
                try:
                    if os.path.getsize(self.owner_path) != 0:
                        return False
                    os.unlink(self.owner_path)
                except OSError:
                    return False
                return True
            try:
                pid = int(json.loads(body).get("pid", 0))
            except ValueError:
                return False      # torn/foreign content: assume live
            if pid <= 0:
                return False
            try:
                os.kill(pid, 0)
                return False      # owner alive
            except ProcessLookupError:
                pass              # owner dead: steal
            except OSError:
                return False      # can't verify: stay safe
            try:
                os.unlink(self.owner_path)
            except OSError:
                return False
            return True
        finally:
            try:
                os.rmdir(mutex)
            except OSError:
                pass

    def release_owner(self) -> None:
        """Drop the owner lock iff this Workspace instance holds it."""
        fd, self._owner_fd = self._owner_fd, None
        if fd is None:
            return
        try:
            os.unlink(self.owner_path)
        except OSError:
            pass
        try:
            os.close(fd)  # drops the flock
        except OSError:
            pass

    @property
    def calibration_path(self) -> str:
        return os.path.join(self.root, CALIBRATION_FILE)

    def load_calibration(self):
        """The job's persisted int8 activation maxima, or None."""
        try:
            with open(self.calibration_path) as f:
                return json.load(f)["act_maxima"]
        except (OSError, KeyError, ValueError):
            return None

    def claim_calibration(self, maxima):
        """First-calibration-wins arbitration (engine.calibration_hook):
        atomically publish `maxima` as THE job's calibration; if another
        worker (or a pre-crash run) already published one, return that
        instead.  One output video must never mix segments quantized with
        different scales, and kill/resume must be reproducible."""
        maxima = [float(v) for v in maxima]
        won, saved = self._claim_json(self.calibration_path,
                                      {"act_maxima": maxima},
                                      self.load_calibration)
        # unreadable existing file (torn by something non-atomic?) ->
        # fall back to our own maxima rather than crash
        return maxima if won or saved is None else saved

    def _claim_json(self, path: str, payload: dict, load):
        """First-wins atomic publication of a small JSON dict at `path`.
        Returns (won, saved): won=True when OUR payload got published;
        otherwise `saved` is load()'s view of the earlier winner (which
        can be None if that file is torn/unreadable — callers fall back
        to their own value).

        Atomicity: write a complete tmp file, then hardlink it into place
        — link() fails with EEXIST exactly once per race, and a reader can
        never observe a half-written file.  Filesystems WITHOUT hardlinks
        (some network/FUSE mounts — exactly where the multi-host lease
        scenario shares a workspace) raise a non-EEXIST OSError; those
        degrade to an O_EXCL create-and-write, which keeps first-wins but
        has a tiny torn-read window (a reader hitting it gets None and
        falls back to its own value — same as a torn pre-existing
        file)."""
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".claim.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            try:
                os.link(tmp, path)
                return True, None
            except FileExistsError:
                return False, load()
            except OSError:
                return self._claim_json_excl(path, payload, load)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _claim_json_excl(self, path: str, payload: dict, load):
        """_claim_json fallback for hardlink-less filesystems: O_EXCL-
        create the file and write it directly (the create is the
        first-wins arbitration; the write is not atomic, so a write
        failure unlinks the file rather than leaving a torn claim other
        workers would defer to)."""
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            return False, load()
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            return True, None
        except BaseException:
            try:
                os.unlink(path)
            except OSError:
                pass
            raise

    # -- int8 certificate + auto-dtype resolution (first-wins) --------------

    @property
    def cert_path(self) -> str:
        return os.path.join(self.root, CERT_FILE)

    @property
    def resolution_path(self) -> str:
        return os.path.join(self.root, RESOLUTION_FILE)

    def load_int8_cert(self) -> Optional[float]:
        """The job's persisted int8-vs-f32 certificate (dB), or None."""
        try:
            with open(self.cert_path) as f:
                return float(json.load(f)["db"])
        except (OSError, KeyError, ValueError, TypeError):
            return None

    def claim_int8_cert(self, db: float) -> float:
        """First-wins publication of the job's int8-vs-f32 PSNR
        certificate: every worker/resume of one job reports (and gates
        on) THE SAME measured dB — the measurement is deterministic up to
        f32 reduction-order noise across independent XLA compiles, and on
        content sitting exactly on a gate that noise must not flip the
        decision between workers."""
        won, saved = self._claim_json(self.cert_path, {"db": float(db)},
                                      self.load_int8_cert)
        return float(db) if won or saved is None else saved

    def load_resolution(self) -> Optional[dict]:
        """The job's persisted --dtype auto decision
        ({"dtype": ..., "db": float|None}), or None."""
        try:
            with open(self.resolution_path) as f:
                d = json.load(f)
            if d.get("dtype") not in ("int8", "bfloat16", "float32"):
                return None
            return {"dtype": d["dtype"],
                    "db": None if d.get("db") is None else float(d["db"])}
        except (OSError, KeyError, ValueError, TypeError):
            return None

    def claim_resolution(self, dtype: str, db: Optional[float]) -> dict:
        """First-wins publication of the --dtype auto decision: shard
        workers racing a fresh workspace (and resumes racing a crashed
        resolution) all follow ONE resolved dtype — one output video must
        never mix int8- and bf16-upscaled segments
        (scheduler.resolve_auto_dtype)."""
        mine = {"dtype": dtype, "db": None if db is None else float(db)}
        won, saved = self._claim_json(self.resolution_path, mine,
                                      self.load_resolution)
        return mine if won or saved is None else saved

    # -- part files --------------------------------------------------------

    def part_path(self, index: int, ext: str = ".mp4") -> str:
        return os.path.join(self.parts_dir, f"{index:06d}{ext}")

    def part_tmp_path(self, index: int, ext: str = ".mp4") -> str:
        # ".tmp" goes before the container extension: writers (cv2/ffmpeg)
        # infer the container format from the final extension.  The pid
        # makes the tmp PER-PROCESS: a stalled shard worker (SIGSTOP, long
        # GC) whose lease was stolen and that later resumes writing can
        # only tear its own tmp file, never the takeover worker's.
        return os.path.join(self.parts_dir,
                            f"{index:06d}.tmp{os.getpid()}{ext}")

    def commit_part(self, index: int, ext: str = ".mp4") -> None:
        """Rename <part>.tmp -> <part>: parts become visible atomically."""
        os.replace(self.part_tmp_path(index, ext), self.part_path(index, ext))

    def completed_parts(self, ext: str = ".mp4") -> List[int]:
        if not os.path.isdir(self.parts_dir):
            return []
        out = []
        for name in os.listdir(self.parts_dir):
            stem, file_ext = os.path.splitext(name)
            if file_ext == ext and stem.isdigit():
                out.append(int(stem))
        return sorted(out)

    def clean_stale_tmp(self) -> int:
        """Delete *.tmp part files left by DEAD encoders only.

        Tmp names embed the writer's pid (part_tmp_path); a tmp whose
        owner is a different, still-alive process is another shard
        worker's in-flight part — unlinking it would make that worker's
        commit_part fail.  Own-pid tmps are always stale (an encoder from
        this process cannot be running when repair is called)."""
        n = 0
        if os.path.isdir(self.parts_dir):
            for name in os.listdir(self.parts_dir):
                i = name.find(".tmp")
                if i < 0:
                    continue
                pid_s = name[i + 4:].split(".", 1)[0]
                if pid_s.isdigit() and int(pid_s) != os.getpid():
                    try:
                        os.kill(int(pid_s), 0)
                    except ProcessLookupError:
                        pass            # owner dead: stale, delete
                    except PermissionError:
                        continue        # owner alive (other uid): keep
                    else:
                        continue        # owner alive: keep
                os.unlink(os.path.join(self.parts_dir, name))
                n += 1
        return n


def repair_pending(state: JobState, workspace: Workspace,
                   all_segments: Optional[List[Segment]] = None,
                   ext: str = ".mp4") -> JobState:
    """Queue repair on resume — the analog of reve-cli/src/main.rs:142-159.

    Rules:
      * stale .tmp part files are deleted (crashed encoder output);
      * any planned segment whose part file does not exist is pending —
        derived from the parts on disk rather than trusting only the saved
        queue, so a crash between part-commit and state-save self-heals;
      * pending list is sorted by index.
    """
    from reve_tpu_torch.pipeline.planner import plan_segments

    workspace.clean_stale_tmp()
    if all_segments is None:
        all_segments = state.plan or plan_segments(
            state.frame_count, state.segment_size
        )
    done = set(workspace.completed_parts(ext))
    pending = [s for s in all_segments if s.index not in done]
    return dataclasses.replace(state, pending=pending)
