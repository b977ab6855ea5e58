"""libstdc++-compatible std::sort / std::partial_sort.

The reference sorts alignment sets and branch-operation lists with
std::sort / std::partial_sort (alignment.h:922-932, kscw.h:249-255,
crcw.h:313-318).  Those are UNSTABLE: the relative order of equal-score
entries is determined by libstdc++'s introsort/heapsort internals.  To keep
byte-level output parity we reimplement the exact GNU libstdc++ algorithms
(median-of-3 introsort with threshold 16 + final insertion sort;
heap-select + sort-heap for partial_sort) from their published structure.

``less(a, b)`` must be a strict weak ordering (the reference uses
``a.score > b.score``).
"""

from __future__ import annotations

_S_THRESHOLD = 16


def _lg(n: int) -> int:
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# heap primitives (bits/stl_heap.h algorithms)

def _push_heap(a, hole, top, value, less):
    parent = (hole - 1) // 2
    while hole > top and less(a[parent], value):
        a[hole] = a[parent]
        hole = parent
        parent = (hole - 1) // 2
    a[hole] = value


def _adjust_heap(a, first, hole, length, value, less):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if less(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    # push_heap on the subrange starting at `first`
    parent = (hole - 1) // 2
    while hole > top and less(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _make_heap(a, first, last, less):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, less)
        if parent == 0:
            return
        parent -= 1


def _pop_heap(a, first, last, result, less):
    value = a[result]
    a[result] = a[first]
    _adjust_heap(a, first, 0, last - first, value, less)


def _sort_heap(a, first, last, less):
    while last - first > 1:
        last -= 1
        _pop_heap(a, first, last, last, less)


def _heap_select(a, first, middle, last, less):
    _make_heap(a, first, middle, less)
    for i in range(middle, last):
        if less(a[i], a[first]):
            _pop_heap(a, first, middle, i, less)


def partial_sort_range(a, first, middle, last, less):
    """std::partial_sort(first, middle, last)."""
    _heap_select(a, first, middle, last, less)
    _sort_heap(a, first, middle, less)


# ---------------------------------------------------------------------------
# introsort (bits/stl_algo.h algorithms)

def _move_median_to_first(a, result, x, y, z, less):
    if less(a[x], a[y]):
        if less(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif less(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif less(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif less(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a, first, last, pivot, less):
    while True:
        while less(a[first], a[pivot]):
            first += 1
        last -= 1
        while less(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, less):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, less)
    return _unguarded_partition(a, first + 1, last, first, less)


def _introsort_loop(a, first, last, depth_limit, less):
    while last - first > _S_THRESHOLD:
        if depth_limit == 0:
            partial_sort_range(a, first, last, last, less)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, less)
        _introsort_loop(a, cut, last, depth_limit, less)
        last = cut


def _unguarded_linear_insert(a, last, less):
    val = a[last]
    nxt = last - 1
    while less(val, a[nxt]):
        a[last] = a[nxt]
        last = nxt
        nxt -= 1
    a[last] = val


def _insertion_sort(a, first, last, less):
    if first == last:
        return
    for i in range(first + 1, last):
        if less(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, less)


def _final_insertion_sort(a, first, last, less):
    if last - first > _S_THRESHOLD:
        _insertion_sort(a, first, first + _S_THRESHOLD, less)
        for i in range(first + _S_THRESHOLD, last):
            _unguarded_linear_insert(a, i, less)
    else:
        _insertion_sort(a, first, last, less)


def cxx_sort(a, less) -> None:
    """std::sort over the whole python list ``a`` (in place)."""
    if len(a) < 2:
        return
    _introsort_loop(a, 0, len(a), 2 * _lg(len(a)), less)
    _final_insertion_sort(a, 0, len(a), less)


def cxx_partial_sort(a, middle, less) -> None:
    """std::partial_sort(a.begin(), a.begin()+middle, a.end()) in place."""
    partial_sort_range(a, 0, middle, len(a), less)
