"""Bounded regex execution (relinear.py).

The reference runs regexes on Go's RE2-class engine — guaranteed linear
(reference tokenizer.go:315-366). These tests prove the rebuild cannot be
stalled by catastrophic backtracking: the risk screen routes pathological
patterns to the Pike VM, the VM agrees with ``re`` everywhere both accept,
and an engine-level ``(a+)+$`` query completes against a crafted row.
"""

import random
import re
import string
import time

import pytest

import bloomsearch_tpu as bs
from bloomsearch_tpu import BloomSearchEngine, BloomSearchEngineConfig, FileSystemDataStore
from bloomsearch_tpu.relinear import (
    LinearMatcher,
    build_safe_matcher,
    pattern_is_risky,
)

TIMEOUT = 10.0


class TestRiskScreen:
    @pytest.mark.parametrize(
        "pattern",
        [
            r"(a+)+$",
            r"(a*)*b",
            r"(a|ab)+c",
            r"(a?){10}a{10}",
            r"([a-z]+)*@",
            r"(\d+|\w+)+!",
            r"(?:x*)+y",
            # Ambiguous alternation nested one (or more) groups deeper than
            # the repeat body's top level — the one-level screen missed
            # these and re hung ~23 s on 'a'*27 (exponential).
            r"((a|a))+b",
            r"((((a|a))))+b",
            r"(?:(?:a|a))+b",
            r"((a|a)x?)+b",
            # Distinct firsts but a variable-length alternative: iteration
            # splits overlap ('ab' = one iter or 'a'+'b') and compound.
            r"(ab?|b)+c",
            # POLYNOMIAL escapes: no nested repeat at all, but adjacent
            # flexible repeats over overlapping alphabets multiply their
            # split choices — a*a*a*a*a*$ is O(n^5) under re on 'a'*n+'b'.
            r"a*a*a*a*a*$",
            r"a*a*$",
            r"\w+\s*\w+$",  # \s* is nullable: the two \w+ become adjacent
            r"a*(x?)a*b",  # nullable separator keeps the stars adjacent
            r"[ab]+b*c",  # class/literal alphabet overlap ('b')
            r".*a.*a$",  # dot overlaps everything
            # IGNORECASE: the screen must compare case-FOLDED literals —
            # (?i)(ab|AB)+c backtracks exactly like (ab|ab)+c (re hung ~4 s
            # on 'ab'*24+'x', doubling per 2 chars). Scoped (?i:...) too.
            r"(?i)(ab|AB)+c",
            r"(?i:(ab|AB))+c",
            r"(?i)a*A*$",
            r"(?i)[Ab]+b*c",  # folded class/literal overlap
        ],
    )
    def test_pathological_flagged(self, pattern):
        assert pattern_is_risky(pattern)

    @pytest.mark.parametrize(
        "pattern",
        [
            r"^pay",
            r"timeout",
            r"error \d+",
            r"^\d{4}-\d{2}-\d{2}$",
            r"(foo|bar) baz",
            r"(foo|bar)+",  # distinct literal firsts: linear under re
            r"[a-z]+@[a-z]+\.(com|net)",
            r"a+b*c?",
            r"\bword\b",
            r"((ab|cd)(ef|gh))+x",  # distinct firsts + fixed lengths: safe
            # Sequential repeats with provably-disjoint alphabets are fine:
            r"connection\s+\w+",
            r"\d+\.\d+\.\d+",
            r"[a-f]+[g-z]+",
            r"b*a+b*",  # mandatory 'a' run separates the disjoint b-stars
            # Case-insensitive but structurally safe: stays on fast re.
            r"(?i)error",
            r"(?i)(foo|bar)+x",
            r"(?i)abc.*def",
            r"(FOO|bar)+x",  # case-SENSITIVE distinct firsts stay distinct
        ],
    )
    def test_common_patterns_stay_on_re(self, pattern):
        assert not pattern_is_risky(pattern)

    def test_ignorecase_ambiguity_bounded_end_to_end(self):
        """(?i)(ab|AB)+c ran on plain re before the fold-aware screen: 4+ s
        at 'ab'*24, doubling every 2 chars. Must now complete bounded with
        semantics preserved (budgeted fallback engine handles the flag)."""
        matcher = build_safe_matcher(r"(?i)(ab|AB)+c")
        t0 = time.monotonic()
        assert matcher("ab" * 30 + "x") is False
        assert time.monotonic() - t0 < TIMEOUT
        assert matcher("zzABabABc!") is True
        assert matcher("abc") is True
        assert matcher("aBc") is True  # mixed-case iteration
        assert matcher("zac") is False

    def test_nested_ambiguous_alternation_bounded(self):
        """The review repro: one extra group layer around (a|a) defeated the
        old screen; matching must now complete instantly, both polarities."""
        for pattern in (r"((a|a))+b", r"((a|a)x?)+b", r"(ab?|b)+c"):
            matcher = build_safe_matcher(pattern)
            t0 = time.monotonic()
            assert matcher("a" * 40 + "z") is False
            assert time.monotonic() - t0 < TIMEOUT
            ref = re.compile(pattern)
            for s in ("xxaab yy", "zzabbc", "a" * 5 + "b", "ab" * 3 + "c"):
                assert matcher(s) == (ref.search(s) is not None), (pattern, s)


class TestFlagRouting:
    """Semantic flags (IGNORECASE/MULTILINE/DOTALL/ASCII, global or scoped)
    compile INTO the Pike VM with exact re parity (round 5 — previously
    they routed to the budgeted fallback, the only path that can error
    where the reference completes)."""

    def test_scoped_inline_flags_parity(self):
        # Risky pattern + scoped IGNORECASE: the VM must model the scoped
        # fold exactly (dropping it made matching rows disappear — a
        # zero-false-negative violation).
        pattern = r"(?i:(a+)+b)"
        vm = LinearMatcher(pattern)
        matcher = build_safe_matcher(pattern)
        ref = re.compile(pattern)
        for s in ("AAAB", "aab", "xxxx", "A" * 30 + "c", "aAaAb"):
            assert vm.search(s) == (ref.search(s) is not None), s
            assert matcher(s) == (ref.search(s) is not None), s
        # The scope must END with the group: the tail 'b' outside stays
        # case-sensitive.
        pattern = r"(?i:(a+)+x)b"
        vm = LinearMatcher(pattern)
        ref = re.compile(pattern)
        for s in ("AAXb", "AAXB", "aaxb", "aaxB"):
            assert vm.search(s) == (ref.search(s) is not None), s

    def test_scoped_dotall_parity(self):
        pattern = r"(?s:(.+)+x)"
        matcher = build_safe_matcher(pattern)
        ref = re.compile(pattern)
        for s in ("a\nbx", "a\nb", "x",):
            assert matcher(s) == (ref.search(s) is not None), repr(s)

    def test_ascii_flag_parity(self):
        # (?a) flips \d to ASCII-only; the VM's class predicates must honor
        # it (Unicode \d would match Arabic-Indic digits the user excluded
        # — wrong results, not just missed ones).
        pattern = r"(?a)(\d+)+x"
        vm = LinearMatcher(pattern)
        matcher = build_safe_matcher(pattern)
        ref = re.compile(pattern)
        for s in ("٣٣x", "12x", "abc", "1x"):
            assert vm.search(s) == (ref.search(s) is not None), repr(s)
            assert matcher(s) == (ref.search(s) is not None), repr(s)

    def test_ignorecase_unicode_edge_parity(self):
        # Kelvin sign / long s / final sigma: the VM delegates folded
        # literals to re itself, so these match exactly like re.
        for pattern, samples in [
            (r"(?i)(k+)+x", ["Kkx", "KKx", "qx"]),
            (r"(?i)(s+)+x", ["ſsx", "SSx", "tx"]),
            (r"(?i)[σ]+x", ["Σx", "ςx", "ax"]),
        ]:
            vm = LinearMatcher(pattern)
            ref = re.compile(pattern)
            for s in samples:
                assert vm.search(s) == (ref.search(s) is not None), (pattern, s)

    def test_multiline_anchor_parity(self):
        pattern = r"(?m)^(x+)+$"
        vm = LinearMatcher(pattern)
        ref = re.compile(pattern)
        for s in ("yy\nxxx", "yy\nxxz", "xxx\nyy", "a\n\nb"):
            assert vm.search(s) == (ref.search(s) is not None), repr(s)

    def test_polynomial_chain_bounded(self):
        # O(n^5) under raw re on a few-KB row; must complete instantly here.
        matcher = build_safe_matcher(r"a*a*a*a*a*$")
        t0 = time.monotonic()
        matcher("a" * 4000 + "b")
        assert time.monotonic() - t0 < TIMEOUT
        ref = re.compile(r"a*a*a*a*a*$")
        for s in ("aaa", "b", "", "ab"):
            assert matcher(s) == (ref.search(s) is not None), repr(s)


class TestLinearMatcherParity:
    """VM boolean-search parity against re on strings both engines accept."""

    PATTERNS = [
        r"(a+)+$",
        r"(a|ab)+c",
        r"(a*)*b",
        r"abc",
        r"^abc$",
        r"a.c",
        r"[abc]+d",
        r"[^xyz]+",
        r"(ab|cd)*ef",
        r"\d+\.\d+",
        r"\w+@\w+",
        r"\s*\btok\b\s*",
        r"x{2,4}y",
        r"(?:ab){3}",
        r"a+?b",
        r"\Astart",
        r"end\Z",
        r"colou?r",
    ]

    def test_parity_fuzz(self):
        rng = random.Random(0xB100F)
        alphabet = "ab cdxyz019.@\n"
        for pattern in self.PATTERNS:
            vm = LinearMatcher(pattern)
            ref = re.compile(pattern)
            cases = ["", "a", "ab", "abc", "aaab", "tok", "start end"]
            cases += [
                "".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 24)))
                for _ in range(200)
            ]
            for s in cases:
                assert vm.search(s) == (ref.search(s) is not None), (pattern, s)

    def test_linear_on_pathological_input(self):
        # re would take ~2^40 steps on this; the VM must finish instantly.
        vm = LinearMatcher(r"(a+)+$")
        evil = "a" * 40 + "b"
        t0 = time.monotonic()
        assert vm.search(evil) is False
        assert vm.search("a" * 40) is True
        assert time.monotonic() - t0 < 1.0

    def test_overlapping_alternation(self):
        vm = LinearMatcher(r"(a|aa)+$")
        assert vm.search("aaa")
        assert not vm.search("aab")


class TestBuildSafeMatcher:
    def test_safe_pattern_uses_re(self):
        m = build_safe_matcher(r"^pay")
        assert m("payment") and not m("repayment")

    def test_risky_pattern_bounded(self):
        m = build_safe_matcher(r"(a+)+$")
        t0 = time.monotonic()
        assert not m("a" * 64 + "!")
        assert time.monotonic() - t0 < 2.0

    def test_invalid_pattern_raises(self):
        with pytest.raises(re.error):
            build_safe_matcher(r"([unclosed")

    def test_unsupported_risky_falls_back_with_budget(self):
        # Lookahead is outside the VM subset; must still return correctly
        # (via the budgeted fallback engine) on a benign input.
        m = build_safe_matcher(r"(?=a)(a+)+$")
        assert m("aaa")


class TestEngineCompletesPathologicalQuery:
    def test_evil_regex_query_completes(self, tmp_path):
        """Reference behavior: RE2 runs (a+)+$ linearly; a crafted row must
        not wedge a block worker."""
        store = FileSystemDataStore(str(tmp_path / "data"))
        engine = BloomSearchEngine(
            BloomSearchEngineConfig(row_data_compression="none"), store, store
        )
        engine.start()
        try:
            rows = [
                {"service": "payment", "message": "a" * 2000 + "!"},  # evil non-match
                {"service": "payment", "message": "a" * 50},  # match
                {"service": "auth", "message": "hello"},
            ]
            engine.ingest_rows(rows, timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            q = bs.new_query().field_regex("message", r"(a+)+$").build()
            t0 = time.monotonic()
            out = engine.query_sync(q, timeout=30.0)
            elapsed = time.monotonic() - t0
            assert elapsed < 20.0
            assert len(out) == 1 and out[0]["message"] == "a" * 50
        finally:
            engine.stop(timeout=TIMEOUT)


class TestFlagAndFallbackRouting:
    def test_ignorecase_risky_pattern_still_correct(self):
        # IGNORECASE risky pattern: VM path since round 5.
        m = build_safe_matcher(r"(?i)(a+)+$")
        assert m("AAA") and not m("AAB")

    def test_multiline_risky_pattern_still_correct(self):
        m = build_safe_matcher(r"(?m)^(x+)+$")
        assert m("yy\nxxx") and not m("yy\nxxz")

    def test_reference_pattern_sweep_never_budgeted(self):
        # Every regex in the reference's own tests (tokenizer_test.go:
        # 280-313, bloom_tree_engine_test.go regex cases) plus RE2-style
        # shapes must run on the screen-cleared re path or the linear VM —
        # NEVER the budgeted fallback, which is the only path that can
        # error where the reference completes.
        from bloomsearch_tpu.relinear import matcher_route

        reference_patterns = [
            r"(?i)^jo", r"^true$", r"^2$", r"^auth$", r"^error$", r"^pay",
            r"^payment$", r"failed", r"timeout", r"timeout$",
        ]
        re2_shapes = [
            r"(?i)(ab|cd)+x", r"(?m)^err.*$", r"(?s)a.+b", r"(?a)\w+\d{2,8}",
            r"[A-Za-z0-9_.+-]+@[a-z]+\.[a-z]{2,6}",
            r"(?i:warn|error)\s+code=\d+", r"(a|b)*c", r"x{2,100}y",
            r"\bword\b", r"(?i)[σk]+x",
        ]
        for p in reference_patterns + re2_shapes:
            assert matcher_route(p) in ("re", "vm"), p

    def test_go_rejected_constructs_route_to_fallback(self):
        # Constructs Go regexp itself REJECTS may still use the budgeted
        # fallback here (we're more permissive than the reference, bounded).
        from bloomsearch_tpu.relinear import matcher_route

        assert matcher_route(r"(a+)\1+b") == "fallback"  # risky + backref
        assert matcher_route(r"(?<=a)(b+)+c") == "fallback"  # risky + lookbehind

    def test_counted_repeat_blowup_routes_to_fallback(self):
        # Program-size cap: (a{0,500}){0,500} would expand enormously.
        m = build_safe_matcher(r"(a{0,500}){0,500}b")
        assert m("aaab") and not m("aaac")


class TestSequentialFlexScreen:
    """Round-4 review fix: many small flexible quantifiers blow up without
    any single one tripping the nested/poly screens ('a?'*k + 'a'*k is
    textbook-exponential; measured 6 s at k=26 on raw re)."""

    def test_sequential_nullable_chain_flagged_and_linear(self):
        import time

        from bloomsearch_tpu.relinear import build_safe_matcher, pattern_is_risky

        k = 26
        pattern = "a?" * k + "a" * k
        assert pattern_is_risky(pattern)
        m = build_safe_matcher(pattern)
        t0 = time.monotonic()
        assert m("a" * k) is True
        assert m("a" * (k - 1)) is False
        assert time.monotonic() - t0 < 2.0  # raw re needs ~6 s at k=26

    def test_bounded_repeat_chain_flagged(self):
        from bloomsearch_tpu.relinear import pattern_is_risky

        assert pattern_is_risky("a{0,31}" * 8 + "a" * 20)

    def test_common_patterns_keep_fast_path(self):
        from bloomsearch_tpu.relinear import pattern_is_risky

        for p in (r"connection\s+\w+", r"^ERROR: .*timeout$", r"(\d+)-(\d+)"):
            assert not pattern_is_risky(p), p

    def test_linear_matcher_long_input_no_quadratic_alloc(self):
        import time

        from bloomsearch_tpu.relinear import LinearMatcher

        m = LinearMatcher("a?" * 20 + "a" * 20)
        t0 = time.monotonic()
        assert m.search("b" * 200_000) is False
        assert m.search("b" * 100_000 + "a" * 20) is True
        assert time.monotonic() - t0 < 10.0
