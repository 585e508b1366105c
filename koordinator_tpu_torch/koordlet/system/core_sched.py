"""Core scheduling: prctl(PR_SCHED_CORE) cookie management.

Reference: pkg/koordlet/util/system/core_sched_linux.go — create/share
core-scheduling cookies so same-core SMT siblings never co-run distrusted
tasks (the groupidentity CPUQOS core-expeller). The raw syscall is
injectable so tests (and non-Linux hosts) use a fake kernel.

Counterpart of ``koordinator_tpu/koordlet/system/core_sched.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Callable, Dict, Optional

PR_SCHED_CORE = 62
#: prctl sub-commands (include/uapi/linux/prctl.h)
PR_SCHED_CORE_GET = 0
PR_SCHED_CORE_CREATE = 1
PR_SCHED_CORE_SHARE_TO = 2
PR_SCHED_CORE_SHARE_FROM = 3

PIDTYPE_PID = 0
PIDTYPE_TGID = 1
PIDTYPE_PGID = 2

PrctlFn = Callable[[int, int, int, int, int], int]


def _libc_prctl() -> PrctlFn:
    libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)

    def call(option, arg2, arg3, arg4, arg5):
        rc = libc.prctl(
            ctypes.c_int(option), ctypes.c_ulong(arg2), ctypes.c_ulong(arg3),
            ctypes.c_ulong(arg4), ctypes.c_ulong(arg5),
        )
        return rc if rc >= 0 else -ctypes.get_errno()

    return call


class CoreSched:
    """Cookie operations over an injectable prctl (core_sched_linux.go
    CoreSchedExtended)."""

    def __init__(self, prctl: Optional[PrctlFn] = None):
        self._prctl = prctl if prctl is not None else _libc_prctl()

    def supported(self) -> bool:
        """Probe PR_SCHED_CORE_GET on self (EINVAL => kernel lacks it)."""
        cookie = ctypes.c_ulonglong(0)
        rc = self._prctl(
            PR_SCHED_CORE, PR_SCHED_CORE_GET, 0, PIDTYPE_PID,
            ctypes.addressof(cookie),
        )
        return rc == 0

    def get(self, pid: int) -> Optional[int]:
        cookie = ctypes.c_ulonglong(0)
        rc = self._prctl(
            PR_SCHED_CORE, PR_SCHED_CORE_GET, pid, PIDTYPE_PID,
            ctypes.addressof(cookie),
        )
        return int(cookie.value) if rc == 0 else None

    def create(self, pid: int, pid_type: int = PIDTYPE_TGID) -> bool:
        """Assign a fresh cookie to the task (group)."""
        return self._prctl(
            PR_SCHED_CORE, PR_SCHED_CORE_CREATE, pid, pid_type, 0
        ) == 0

    def share_to(self, pid: int, pid_type: int = PIDTYPE_TGID) -> bool:
        """Push the caller's cookie onto ``pid``."""
        return self._prctl(
            PR_SCHED_CORE, PR_SCHED_CORE_SHARE_TO, pid, pid_type, 0
        ) == 0

    def share_from(self, pid: int) -> bool:
        """Pull ``pid``'s cookie onto the caller."""
        return self._prctl(
            PR_SCHED_CORE, PR_SCHED_CORE_SHARE_FROM, pid, PIDTYPE_PID, 0
        ) == 0

    def assign_group_cookie(self, leader_pid: int, member_pids) -> int:
        """Give a task group one shared cookie (the groupidentity
        core-expeller flow: create on the leader unless it already has a
        cookie, share to members); returns how many members were tagged."""
        if not self.get(leader_pid):
            if not self.create(leader_pid, PIDTYPE_PID):
                return 0
        tagged = 0
        for pid in member_pids:
            if pid == leader_pid:
                continue
            if self.share_from(leader_pid) and self.share_to(pid, PIDTYPE_PID):
                tagged += 1
        return tagged


class FakeKernel:
    """In-memory PR_SCHED_CORE (tests / unsupported hosts)."""

    def __init__(self, supported: bool = True):
        self.cookies: Dict[int, int] = {}
        self._next = 1
        self._supported = supported
        self._caller = 0  # the "current" task

    def prctl(self, option, arg2, pid, pid_type, arg5):
        if option != PR_SCHED_CORE or not self._supported:
            return -22  # EINVAL
        if arg2 == PR_SCHED_CORE_GET:
            ctypes.cast(arg5, ctypes.POINTER(ctypes.c_ulonglong))[0] = (
                self.cookies.get(pid, 0)
            )
            return 0
        if arg2 == PR_SCHED_CORE_CREATE:
            self.cookies[pid] = self._next
            self._next += 1
            return 0
        if arg2 == PR_SCHED_CORE_SHARE_TO:
            self.cookies[pid] = self.cookies.get(self._caller, 0)
            return 0
        if arg2 == PR_SCHED_CORE_SHARE_FROM:
            self.cookies[self._caller] = self.cookies.get(pid, 0)
            return 0
        return -22
