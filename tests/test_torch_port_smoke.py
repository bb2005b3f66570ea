"""chip_smoke.py's reading of a profiled window's device records, on the
CPU: which calls of a window it reads and what each of them launched.

A window holds one call for each marker, each call closed by its marker,
and ends with a tail of other fills. A call is read only where its marker
and the marker before it came back, so a lost marker never merges two
calls, and a lost kernel record only lowers its call's count.
"""

import pytest

from chip_smoke import MARKERS, calls_read, marker_of

SHORT = ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::FillFunctor<short>, std::array<char*, 1ul> >"
         "(int, at::native::FillFunctor<short>, std::array<char*, 1ul>)")
CFLOAT = ("void at::native::vectorized_elementwise_kernel<4, "
          "at::native::FillFunctor<c10::complex<float> >, "
          "std::array<char*, 1ul> >(int, "
          "at::native::FillFunctor<c10::complex<float> >, "
          "std::array<char*, 1ul>)")
CDOUBLE_MANGLED = ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11"
                   "FillFunctorIN3c107complexIdEEEESt5arrayIPcLm1EEEEviT0_T1_")
SHORT_MANGLED = ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11"
                 "FillFunctorIsEESt5arrayIPcLm1EEEEviT0_T1_")
FLOAT = ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::FillFunctor<float>, std::array<char*, 1ul> >"
         "(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)")
KERNEL = "void norm_act_pad_kernel<float, 4, false>(float const*, float*)"
READ = "norm_act_pad_kernel<float, 4, false>"


@pytest.mark.parametrize("name, index", [
    (SHORT, 0), (SHORT_MANGLED, 0), (CFLOAT, 1), (CDOUBLE_MANGLED, 2),
    (FLOAT, None), (KERNEL, None)])
def test_marker_of_names_each_marker_and_nothing_else(name, index):
    assert len(MARKERS) == 3
    assert marker_of(name) == index


@pytest.mark.parametrize("names, want", [
    # Every record came back: three calls; the tail is not read.
    ([KERNEL, SHORT, KERNEL, CFLOAT, KERNEL, CDOUBLE_MANGLED, FLOAT, FLOAT],
     [[READ], [READ], [READ]]),
    # The second marker was lost: the second and third calls are not read
    # (they would read as one call of two launches).
    ([KERNEL, SHORT, KERNEL, KERNEL, CDOUBLE_MANGLED, FLOAT], [[READ]]),
    # The first call's kernel was lost: that call reads low.
    ([SHORT, KERNEL, CFLOAT, CDOUBLE_MANGLED], [[], [READ], []]),
    # The first marker was lost: the first two calls are not read.
    ([KERNEL, KERNEL, CFLOAT, KERNEL, CDOUBLE_MANGLED], [[READ]]),
    # Nothing came back.
    ([], []),
])
def test_calls_read_reads_each_call_between_its_markers(names, want):
    assert calls_read(names) == want
