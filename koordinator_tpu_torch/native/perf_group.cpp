// Grouped perf-counter reader: cycles + instructions in one group, the
// native source behind the CPI collector.
//
// Counterpart of koordinator_tpu/native/perf_group.cpp, the same source:
// the port of upstream koordinator's only native component, the
// cgo+libpfm4 perf-group reader (pkg/koordlet/util/perf_group/
// perf_group_linux.go:39-40,93,280-297). libpfm4 is used there
// to resolve event encodings; cycles/instructions are architectural
// PERF_TYPE_HARDWARE events, so this implementation calls
// perf_event_open(2) directly with PERF_FORMAT_GROUP — one leader
// (cycles) plus one sibling (instructions), read atomically as a group
// exactly like pfm-initialized groups are.
//
// A deterministic fake backend (kp_open_fake) exists for tests and for
// hosts where perf_event_open is unavailable (containers with
// perf_event_paranoid locked down).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdlib>

#if defined(__linux__)
#include <linux/perf_event.h>
#include <sys/ioctl.h>
#include <sys/syscall.h>
#include <unistd.h>
#endif

extern "C" {

struct kp_group {
    int leader_fd;     // cycles (group leader)
    int instr_fd;      // instructions (sibling)
    int fake;          // 1 = deterministic fake backend
    unsigned long long fake_cycles;
    unsigned long long fake_instr;
    unsigned long long fake_cycles_step;
    unsigned long long fake_instr_step;
};

// read format with PERF_FORMAT_GROUP | PERF_FORMAT_ID:
// { nr, [ {value, id} x nr ] }
struct kp_read_group {
    unsigned long long nr;
    struct { unsigned long long value, id; } values[2];
};

#if defined(__linux__)
static int kp_perf_open(unsigned int config, int pid, int cpu, int group_fd,
                        unsigned long flags) {
    struct perf_event_attr attr;
    memset(&attr, 0, sizeof(attr));
    attr.type = PERF_TYPE_HARDWARE;
    attr.size = sizeof(attr);
    attr.config = config;
    attr.disabled = (group_fd == -1) ? 1 : 0;  // group starts disabled
    // NOTE: inherit must stay 0 — the kernel rejects inherit with
    // PERF_FORMAT_GROUP (EINVAL since 4.13); cgroup-scoped per-cpu
    // events don't need it anyway
    attr.read_format = PERF_FORMAT_GROUP | PERF_FORMAT_ID;
    attr.exclude_kernel = 1;  // unprivileged-friendly
    attr.exclude_hv = 1;
    return (int)syscall(__NR_perf_event_open, &attr, pid, cpu, group_fd,
                        flags);
}
#endif

// Open a cycles+instructions group. pid/cpu/flags follow
// perf_event_open(2): (pid=0, cpu=-1, flags=0) profiles the calling
// process; (pid=cgroup_fd, cpu>=0, flags=PERF_FLAG_PID_CGROUP) profiles
// a cgroup on one cpu, as the reference does per container.
// Returns a handle pointer, or NULL (errno in *err).
kp_group* kp_open(int pid, int cpu, unsigned long flags, int* err) {
#if defined(__linux__)
    kp_group* g = (kp_group*)calloc(1, sizeof(kp_group));
    if (!g) { if (err) *err = ENOMEM; return NULL; }
    g->leader_fd = kp_perf_open(PERF_COUNT_HW_CPU_CYCLES, pid, cpu, -1, flags);
    if (g->leader_fd < 0) {
        if (err) *err = errno;
        free(g);
        return NULL;
    }
    g->instr_fd = kp_perf_open(PERF_COUNT_HW_INSTRUCTIONS, pid, cpu,
                               g->leader_fd, flags);
    if (g->instr_fd < 0) {
        if (err) *err = errno;
        close(g->leader_fd);
        free(g);
        return NULL;
    }
    ioctl(g->leader_fd, PERF_EVENT_IOC_RESET, PERF_IOC_FLAG_GROUP);
    ioctl(g->leader_fd, PERF_EVENT_IOC_ENABLE, PERF_IOC_FLAG_GROUP);
    return g;
#else
    if (err) *err = ENOSYS;
    return NULL;
#endif
}

// Deterministic fake: every read advances by the given steps.
kp_group* kp_open_fake(unsigned long long cycles_step,
                       unsigned long long instr_step) {
    kp_group* g = (kp_group*)calloc(1, sizeof(kp_group));
    if (!g) return NULL;
    g->fake = 1;
    g->leader_fd = -1;
    g->instr_fd = -1;
    g->fake_cycles_step = cycles_step;
    g->fake_instr_step = instr_step;
    return g;
}

// Cumulative (cycles, instructions); returns 0 on success, else errno.
int kp_read_counters(kp_group* g, unsigned long long* cycles,
                     unsigned long long* instructions) {
    if (!g) return EINVAL;
    if (g->fake) {
        g->fake_cycles += g->fake_cycles_step;
        g->fake_instr += g->fake_instr_step;
        *cycles = g->fake_cycles;
        *instructions = g->fake_instr;
        return 0;
    }
#if defined(__linux__)
    kp_read_group buf;
    memset(&buf, 0, sizeof(buf));
    ssize_t n = read(g->leader_fd, &buf, sizeof(buf));
    if (n < 0) return errno;
    if (buf.nr < 2) return EIO;
    *cycles = buf.values[0].value;
    *instructions = buf.values[1].value;
    return 0;
#else
    return ENOSYS;
#endif
}

void kp_close(kp_group* g) {
    if (!g) return;
#if defined(__linux__)
    if (g->leader_fd >= 0) close(g->leader_fd);
    if (g->instr_fd >= 0) close(g->instr_fd);
#endif
    free(g);
}

int kp_is_fake(kp_group* g) { return g ? g->fake : 0; }

const char* kp_version() { return "koordperf-1.0"; }

}  // extern "C"
