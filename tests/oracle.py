"""Numpy test oracles: independent Python-3 implementations of the behaviors
specified in SURVEY.md (frozen from the reference's documented semantics),
used to verify the JAX implementations.  Written for clarity, not speed —
these run the naive recurrences the device code must reproduce exactly.
"""

from __future__ import annotations

import numpy as np

from real_time_audio_sync_tpu.features.filterbank import chroma_filterbank

FFT_LEN = 4096
HOP_SIZE = 2048
FS = 22050


# ---------------------------------------------------------------------------
# Feature frontend oracle (semantics of reference chroma.py:44-75)
# ---------------------------------------------------------------------------


def oracle_stft(wav: np.ndarray, fft_len: int = FFT_LEN, hop: int = HOP_SIZE) -> np.ndarray:
    x = np.concatenate((np.zeros(fft_len // 2), np.asarray(wav, np.float64)))
    n = len(x)
    num_hops = (n - fft_len) // hop + 1  # py2 floor division semantics
    if num_hops <= 0:
        return np.zeros((fft_len // 2 + 1, 0), dtype=complex)
    win = np.hanning(fft_len)
    out = np.empty((fft_len // 2 + 1, num_hops), dtype=complex)
    for m in range(num_hops):
        out[:, m] = np.fft.rfft(x[m * hop : m * hop + fft_len] * win)
    return out


def oracle_chroma_from_stft(stft: np.ndarray, normalize: bool = True) -> np.ndarray:
    spec = np.abs(stft) ** 2
    fb = chroma_filterbank(FS, FFT_LEN)
    raw = fb @ spec
    if not normalize:
        return raw
    norms = np.sqrt(np.sum(raw ** 2, axis=0))
    norms = np.where(norms < np.finfo(np.float64).tiny, 1.0, norms)
    return raw / norms[None, :]


def oracle_chroma(wav: np.ndarray) -> np.ndarray:
    return oracle_chroma_from_stft(oracle_stft(wav))


# ---------------------------------------------------------------------------
# Offline DTW oracle (semantics of reference dtw.py:5-53)
# ---------------------------------------------------------------------------


def oracle_dtw(seq_a: np.ndarray, seq_b: np.ndarray):
    return oracle_dtw_from_cost(1.0 - seq_a.T @ seq_b)


def oracle_dtw_from_cost(cost: np.ndarray):
    m, n = cost.shape
    acc = np.zeros((m, n))
    back = np.empty((m, n), dtype=np.int64)
    acc[0, 0] = cost[0, 0]
    back[0, 0] = 2
    for i in range(1, m):
        acc[i, 0] = cost[i, 0] + acc[i - 1, 0]
        back[i, 0] = 1
    for j in range(1, n):
        acc[0, j] = cost[0, j] + acc[0, j - 1]
        back[0, j] = 0
    for i in range(1, m):
        for j in range(1, n):
            options = (
                acc[i, j - 1] + cost[i, j],
                acc[i - 1, j] + cost[i, j],
                acc[i - 1, j - 1] + 2 * cost[i, j],
            )
            k = int(np.argmin(options))
            acc[i, j] = options[k]
            back[i, j] = k
    steps = ((0, -1), (-1, 0), (-1, -1))
    i, j = m - 1, n - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        di, dj = steps[back[i, j]]
        i, j = i + di, j + dj
        path.append((i, j))
    path.reverse()
    return cost, acc, np.array(path)


# ---------------------------------------------------------------------------
# Online time warping oracle (semantics of reference otw_eran.py /
# livenote.py / livenote_v2.py — parametrized over their documented diffs)
# ---------------------------------------------------------------------------


class OracleOTW:
    """Banded online DTW, Dixon-2005 style.

    ``variant``:
      - "otw"       — otw_eran.py semantics (run_count starts at 1, startup
                      condition ``t < c``, sentinel 1e10, path appended every
                      set_direction call)
      - "livenote"  — livenote.py semantics (run_count starts at 0, startup
                      ``live_ptr < band``, sentinel inf)
      - "livenote_v2" — livenote_v2.py: LiveNote plus monotone-path guard and
                      optional Euclidean cost (``euclidean=True``)
    """

    def __init__(self, ref, c, max_run_count, variant="otw", euclidean=False,
                 follow=None, atol=0.0, rtol=0.0):
        """``follow``/``atol``/``rtol``: check a float32 engine's path
        without demanding that f32 resolve what f64 resolves.  Where the
        oracle's best point and ``follow``'s point at the same decision
        differ, the followed point is taken if it lies in the same bands and
        its f64 accumulated cost exceeds the best one by at most
        ``atol + rtol * |best|`` — a tie at the engine's precision; each
        such decision's gap is recorded in ``tie_gaps``.  Any other
        difference leaves the oracle on its own path.  Every decision
        appends a point only without the monotone guard, so ``follow``
        needs variant "otw" or "livenote"."""
        if follow is not None and variant == "livenote_v2":
            raise ValueError("follow needs one path point per decision (no monotone guard)")
        self.follow = None if follow is None else [tuple(p) for p in np.asarray(follow)]
        self.atol, self.rtol = atol, rtol
        self.tie_gaps = []
        self.variant = variant
        self.euclidean = euclidean
        self.c = c
        self.max_run_count = max_run_count
        self.ref = np.asarray(ref, np.float64)
        f, n = self.ref.shape
        m = 2 * n
        self.live = np.zeros((f, m))
        sentinel = 1e10 if variant == "otw" else np.inf
        self.acc = np.full((m, n), sentinel)
        self.cost = np.full((m, n), -1.0)
        self.t = 0
        self.j = 0
        self.previous = None
        self.run_count = 1 if variant == "otw" else 0
        self.direction = "both"
        self.path = []
        self.first = True
        self.stopped = False

    # -- DP cell -----------------------------------------------------------
    def _eval(self, x, y):
        if self.euclidean:
            c = np.sqrt(np.sum((self.live[:, x] - self.ref[:, y]) ** 2))
        else:
            c = 1.0 - self.live[:, x] @ self.ref[:, y]
        self.cost[x, y] = c
        if x == 0 and y == 0:
            self.acc[x, y] = c
            return
        steps = []
        if self.variant == "otw":
            if y > 0:
                steps.append(self.acc[x, y - 1] + c)
            if x > 0:
                steps.append(self.acc[x - 1, y] + c)
        else:  # livenote evaluates x-steps first; min() is order-invariant
            if x > 0:
                steps.append(self.acc[x - 1, y] + c)
            if y > 0:
                steps.append(self.acc[x, y - 1] + c)
        if x > 0 and y > 0:
            steps.append(self.acc[x - 1, y - 1] + 2 * c)
        if steps:
            self.acc[x, y] = min(steps)

    # -- band argmins ------------------------------------------------------
    def _best_point(self):
        j1 = max(0, self.j - self.c + 1)
        best_j = j1 + int(np.argmin(self.acc[self.t, j1 : self.j + 1]))
        cost_j = self.acc[self.t, best_j]
        t1 = max(0, self.t - self.c + 1)
        best_t = t1 + int(np.argmin(self.acc[t1 : self.t + 1, self.j]))
        cost_t = self.acc[best_t, self.j]
        best = (self.t, best_j) if cost_j < cost_t else (best_t, self.j)
        k = len(self.path)
        if self.follow is not None and k < len(self.follow) and self.follow[k] != best:
            fx, fy = (int(v) for v in self.follow[k])
            in_band = ((fx == self.t and j1 <= fy <= self.j)
                       or (fy == self.j and t1 <= fx <= self.t))
            low = self.acc[best]
            gap = self.acc[fx, fy] - low if in_band else np.inf
            if gap <= self.atol + self.rtol * abs(low):
                self.tie_gaps.append(float(gap))
                return (fx, fy)
        return best

    def _get_direction(self):
        x, y = self._best_point()
        if self.variant == "livenote_v2":
            if not self.path or (x > self.path[-1][0] and y >= self.path[-1][1]):
                self.path.append((x, y))
        else:
            self.path.append((x, y))
        if self.t < self.c:
            return "both"
        if self.run_count >= self.max_run_count:
            return "column" if self.previous == "row" else "row"
        if x < self.t:
            return "column"
        if y < self.j:
            return "row"
        return "both"

    def _update_run_count(self, direction):
        if direction == self.previous:
            self.run_count += 1
        else:
            self.run_count = 1
        if direction != "both":
            self.previous = direction

    # -- streaming insert (otw_eran.py:38-85 / livenote.py:37-98) ----------
    def insert(self, col):
        if self.stopped:
            return "stop"
        if self.first:
            self.first = False
            self.live[:, self.t] = col
            self._eval(self.t, self.j)
            return None
        self.t += 1
        if self.t >= self.live.shape[1]:
            return None  # "ran out of room" — reference prints and returns
        self.live[:, self.t] = col
        for k in range(max(0, self.j - self.c + 1), self.j + 1):
            self._eval(self.t, k)
        while True:
            if self.direction != "row":
                self.j += 1
                if self.j >= self.ref.shape[1]:
                    self.stopped = True
                    return "stop"
                for k in range(max(0, self.t - self.c + 1), self.t + 1):
                    self._eval(k, self.j)
            direction = self._get_direction()
            self._update_run_count(direction)
            self.direction = direction
            if direction != "column":
                break
        return None

    # -- batch mode (otw_eran.py:91-142 / livenote.py:102-149) -------------
    def set_live(self, live):
        live = np.asarray(live, np.float64)
        if self.variant == "otw":
            # otw_eran.set_live resets state (otw_eran.py:92-97)
            self.t = 0
            self.j = 0
            self.previous = None
            self.direction = "both"
            self.run_count = 1
            self.path = []
        self.live[:, self.t] = live[:, self.t]
        self._eval(self.t, self.j)
        while True:
            direction = self._get_direction()
            if self.variant == "otw":
                # otw_eran processes row first when not 'column'
                pass
            if direction != "column":
                self.t += 1
                if self.t >= live.shape[1] or self.t >= self.live.shape[1]:
                    break
                self.live[:, self.t] = live[:, self.t]
                for k in range(max(0, self.j - self.c + 1), self.j + 1):
                    self._eval(self.t, k)
            if direction != "row":
                self.j += 1
                if self.j >= self.ref.shape[1]:
                    break
                for k in range(max(0, self.t - self.c + 1), self.t + 1):
                    self._eval(k, self.j)
            self._update_run_count(direction)
        return np.array(self.path)


# ---------------------------------------------------------------------------
# WTW oracle (semantics of reference wtw.py:19-240) — feature extraction is
# injected so the windowed-DTW algorithm can be tested in isolation
# ---------------------------------------------------------------------------


class OracleWTW:
    def __init__(self, chroma_ref, fft_len, hop_size, dtw_win_size, dtw_hop_size, col_fn):
        self.chroma_ref = np.asarray(chroma_ref, np.float64)
        self.fft_len = fft_len
        self.hop_size = hop_size
        self.w = dtw_win_size // hop_size
        self.hop_frames = dtw_hop_size // hop_size
        self.col_fn = col_fn  # 4096 samples -> 12-dim chroma column
        self.N = self.chroma_ref.shape[1] * 2
        self.M = self.chroma_ref.shape[1]
        self.chroma_live = np.zeros((12, self.N))
        self.acc = np.full((self.N, self.M), np.inf)
        self.buf = []
        self.path = []
        self.chroma_ptr = 0
        self.live_ptr = 0
        self.ref_ptr = 0

    def insert(self, live_audio_buf):
        self.buf += list(live_audio_buf)
        if self.ref_ptr >= self.M - 1 or self.live_ptr >= self.N - 1:
            return "stop"
        while len(self.buf) >= self.fft_len:
            section = np.array(self.buf[: self.fft_len])
            self.buf = self.buf[self.hop_size:]
            self.chroma_live[:, self.chroma_ptr] = self.col_fn(section)
            self.chroma_ptr += 1
            if self.ref_ptr >= (self.M - 1 - self.w) or self.live_ptr >= (self.N - 1 - self.w):
                return "stop"
            while self.chroma_ptr - self.live_ptr >= self.w:
                self._window()
        return None

    def _cost(self, x, y):
        dots = x.T @ y
        nx = np.linalg.norm(x, axis=0)
        ny = np.linalg.norm(y, axis=0)
        return 1.0 - dots / (nx[:, None] * ny[None, :])

    def _run_dtw(self, C):
        n, m = C.shape
        D = np.empty((n, m))
        B = np.empty((n, m))
        D[0, 0] = C[0, 0]
        B[0, 0] = 0
        cost = C[0, 0]
        for i in range(1, n):
            cost += C[i, 0]
            D[i, 0] = cost
            B[i, 0] = 3
        cost = C[0, 0]
        for i in range(1, m):
            cost += C[0, i]
            D[0, i] = cost
            B[0, i] = 1
        for i in range(1, n):
            for j in range(1, m):
                cands = [(D[i - 1, j], 3), (D[i, j - 1], 1), (D[i - 1, j - 1], 2)]
                best, code = cands[0]
                for v, cd in cands[1:]:
                    if v < best:
                        best, code = v, cd
                D[i, j] = best + C[i, j]
                B[i, j] = code
        return D, B

    def _find_path(self, B):
        cur = (B.shape[0] - 1, B.shape[1] - 1)
        path = [cur]
        while cur != (0, 0):
            code = B[cur]
            if code == 1:
                cur = (cur[0], cur[1] - 1)
            elif code == 2:
                cur = (cur[0] - 1, cur[1] - 1)
            else:
                cur = (cur[0] - 1, cur[1])
            path.append(cur)
        path.reverse()
        return path

    def _window(self):
        w = self.w
        x = self.chroma_live[:, self.live_ptr : self.live_ptr + w]
        y = self.chroma_ref[:, self.ref_ptr : self.ref_ptr + w]
        D, B = self._run_dtw(self._cost(x, y))
        self.acc[self.live_ptr : self.live_ptr + w, self.ref_ptr : self.ref_ptr + w] = D
        subpath = self._find_path(B)
        next_start = self.hop_frames
        change = False
        index = None
        for i in range(len(subpath)):
            l, r = subpath[i]
            if l <= next_start:
                self.path.append((l + self.live_ptr, r + self.ref_ptr))
            else:
                change = True
                index = i - 1
                break
        if change:
            self.live_ptr = subpath[index][0] + self.live_ptr
            self.ref_ptr = subpath[index][1] + self.ref_ptr
        else:
            self.live_ptr += self.hop_frames
            self.ref_ptr += self.hop_frames
