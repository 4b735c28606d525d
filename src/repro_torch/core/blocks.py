"""Combinational datapath building blocks over the circuit IR.

These are the structures FloPoCo would emit as VHDL: ripple-carry adders,
barrel shifters with sticky collection, leading-zero counters, array
multipliers, comparators.  All buses are lists of node ids, LSB first.
"""
from __future__ import annotations

from .circuit import FALSE, TRUE, Graph


def const_bus(g: Graph, value: int, width: int) -> list[int]:
    return [TRUE if (value >> i) & 1 else FALSE for i in range(width)]


def bus_value_known(bus: list[int]) -> int | None:
    """If every wire is constant, return the integer value, else None."""
    v = 0
    for i, w in enumerate(bus):
        if w == TRUE:
            v |= 1 << i
        elif w != FALSE:
            return None
    return v


def full_adder(g: Graph, a: int, b: int, cin: int) -> tuple[int, int]:
    """Returns (sum, carry).  The classic 5-gate form; hash-consing will
    share the a^b term between sum and carry (paper Listing 1)."""
    axb = g.XOR(a, b)
    s = g.XOR(axb, cin)
    # carry = (a & b) | (cin & (a ^ b))
    cout = g.OR(g.AND(a, b), g.AND(cin, axb))
    return s, cout


def ripple_add(g: Graph, a: list[int], b: list[int], cin: int = FALSE,
               width: int | None = None) -> tuple[list[int], int]:
    """a + b (+cin) over `width` bits (default max input width).
    Returns (sum_bus, carry_out)."""
    if width is None:
        width = max(len(a), len(b))
    out = []
    c = cin
    for i in range(width):
        ai = a[i] if i < len(a) else FALSE
        bi = b[i] if i < len(b) else FALSE
        s, c = full_adder(g, ai, bi, c)
        out.append(s)
    return out, c


def negate(g: Graph, a: list[int]) -> list[int]:
    inv = [g.NOT(x) for x in a]
    s, _ = ripple_add(g, inv, const_bus(g, 0, len(a)), cin=TRUE)
    return s


def ripple_sub(g: Graph, a: list[int], b: list[int],
               width: int | None = None) -> tuple[list[int], int]:
    """a - b.  Returns (diff, borrow_out) where borrow_out=1 iff a < b
    (unsigned)."""
    if width is None:
        width = max(len(a), len(b))
    binv = [g.NOT(b[i]) if i < len(b) else TRUE for i in range(width)]
    diff, carry = ripple_add(g, a, binv, cin=TRUE, width=width)
    return diff, g.NOT(carry)


def increment(g: Graph, a: list[int], en: int = TRUE) -> tuple[list[int], int]:
    """a + en. Returns (sum, carry_out). Half-adder chain."""
    out = []
    c = en
    for x in a:
        out.append(g.XOR(x, c))
        c = g.AND(x, c)
    return out, c


def eq_zero(g: Graph, a: list[int]) -> int:
    r = TRUE
    for x in a:
        r = g.AND(r, g.NOT(x))
    return r


def bus_eq(g: Graph, a: list[int], b: list[int]) -> int:
    assert len(a) == len(b)
    r = TRUE
    for x, y in zip(a, b):
        r = g.AND(r, g.XNOR(x, y))
    return r


def ult(g: Graph, a: list[int], b: list[int]) -> int:
    """Unsigned a < b via subtract borrow."""
    _, borrow = ripple_sub(g, a, b)
    return borrow


def ucmp(g: Graph, a: list[int], b: list[int]) -> tuple[int, int]:
    """Unsigned (a < b, a > b) from one subtract chain + an equality
    reduce — cheaper than two independent :func:`ult` subtracts when a
    comparator needs both directions (the FP max swap logic)."""
    lt = ult(g, a, b)
    n = max(len(a), len(b))
    eq = TRUE
    for i in range(n):
        ai = a[i] if i < len(a) else FALSE
        bi = b[i] if i < len(b) else FALSE
        eq = g.AND(eq, g.XNOR(ai, bi))
    return lt, g.AND(g.NOT(lt), g.NOT(eq))


def mux_bus(g: Graph, s: int, a: list[int], b: list[int]) -> list[int]:
    """s ? a : b, element-wise (buses padded with FALSE)."""
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        ai = a[i] if i < len(a) else FALSE
        bi = b[i] if i < len(b) else FALSE
        out.append(g.MUX(s, ai, bi))
    return out


def shr_barrel(g: Graph, a: list[int], shamt: list[int],
               collect_sticky: bool = False) -> tuple[list[int], int]:
    """Logical right shift of `a` by the unsigned value of `shamt`.

    Shift amounts >= len(a) shift everything out.  If collect_sticky,
    also returns the OR of all bits shifted out (FP alignment sticky).
    """
    cur = list(a)
    sticky = FALSE
    for k, sbit in enumerate(shamt):
        dist = 1 << k
        if dist >= len(cur):
            # shifting by this power empties the bus entirely
            if collect_sticky:
                any_bit = FALSE
                for x in cur:
                    any_bit = g.OR(any_bit, x)
                sticky = g.OR(sticky, g.AND(sbit, any_bit))
            cur = [g.MUX(sbit, FALSE, x) for x in cur]
            continue
        if collect_sticky:
            lost = FALSE
            for x in cur[:dist]:
                lost = g.OR(lost, x)
            sticky = g.OR(sticky, g.AND(sbit, lost))
        nxt = []
        for i in range(len(cur)):
            hi = cur[i + dist] if i + dist < len(cur) else FALSE
            nxt.append(g.MUX(sbit, hi, cur[i]))
        cur = nxt
    return cur, sticky


def shl_barrel(g: Graph, a: list[int], shamt: list[int]) -> list[int]:
    """Logical left shift (bits shifted past MSB are dropped)."""
    cur = list(a)
    for k, sbit in enumerate(shamt):
        dist = 1 << k
        nxt = []
        for i in range(len(cur)):
            lo = cur[i - dist] if i - dist >= 0 else FALSE
            nxt.append(g.MUX(sbit, lo, cur[i]))
        cur = nxt
    return cur


def normalize_shift(g: Graph, a: list[int]) -> tuple[list[int], list[int]]:
    """Fused leading-zero count + left shift (a 'normalizer').

    Returns (shifted, count) where `shifted` has the leading one of `a`
    at the MSB position and `count` is the shift amount (== lzc when a
    is nonzero).  Cheaper than lzc + shl_barrel because the zero-check of
    each stage feeds its own mux row directly (what Genus would do to
    the FloPoCo normalization cone).
    """
    n = len(a)
    stages = max(1, (n - 1).bit_length())
    cur = list(a)
    count: list[int] = []
    for k in reversed(range(stages)):
        dist = 1 << k
        # top `dist` bits all zero?
        top = cur[n - dist:]
        allz = TRUE
        for x in top:
            allz = g.AND(allz, g.NOT(x))
        if dist >= n:
            count.append(FALSE)
            continue
        nxt = []
        for i in range(n):
            lo = cur[i - dist] if i - dist >= 0 else FALSE
            nxt.append(g.MUX(allz, lo, cur[i]))
        cur = nxt
        count.append(allz)
    count.reverse()  # LSB first
    return cur, count


def lzc(g: Graph, a: list[int]) -> list[int]:
    """Leading-zero count of `a` (MSB = a[-1]).  Output width is
    ceil(log2(len(a)+1)).  If a == 0 the count saturates at len(a)."""
    n = len(a)
    width = max(1, (n).bit_length())
    # Priority encode from MSB down: count = index of first 1 from top.
    count = const_bus(g, n, width)  # all-zero case
    for i in range(n):  # i = 0 is LSB; scan from LSB up so MSB wins last
        cnt_here = const_bus(g, n - 1 - i, width)
        count = mux_bus(g, a[i], cnt_here, count)
    return count


def mul_unsigned(g: Graph, a: list[int], b: list[int]) -> list[int]:
    """Array multiplier; result width len(a)+len(b)."""
    n, m = len(a), len(b)
    acc: list[int] = [FALSE] * (n + m)
    for j in range(m):
        pp = [g.AND(a[i], b[j]) for i in range(n)]
        # accumulate pp << j into acc[j : j+n+1]
        seg = acc[j:j + n]
        summed, carry = ripple_add(g, seg, pp)
        acc[j:j + n] = summed
        # propagate carry upward
        k = j + n
        while carry != FALSE and k < n + m:
            s = g.XOR(acc[k], carry)
            carry = g.AND(acc[k], carry)
            acc[k] = s
            k += 1
    return acc


def or_reduce(g: Graph, bus: list[int]) -> int:
    r = FALSE
    for x in bus:
        r = g.OR(r, x)
    return r


def and_reduce(g: Graph, bus: list[int]) -> int:
    r = TRUE
    for x in bus:
        r = g.AND(r, x)
    return r
