"""Pandas ExtensionArray conformance of the port's SearchArray via pandas'
own extension-array suites: the twin of tests/test_extension_array.py,
its fixtures indexed on ``device="cpu"``, with the same two suites left
out (unique and value_counts normalisation on inverted-index rows) and
the same expected failure.  Arrays pandas makes itself (``_from_sequence``)
take the default device, "cuda", and keep their index on the host, since
these suites search nothing.
"""
import pandas as pd
import pytest
from pandas.tests.extension import base

from searcharray_tpu_torch import SearchArray, Terms, TermsDtype


def index(docs):
    return SearchArray.index(docs, device="cpu")


@pytest.fixture
def dtype():
    return TermsDtype()


@pytest.fixture
def data():
    # pandas >= 3.0 extension suite requires a length-10 fixture with
    # data[0] != data[1], both non-missing.
    return index(
        ["foo bar bar baz", "data2", "data3 bar", "bunny funny wunny"] * 2
        + ["cats dogs", "fish fowl"]
    )


@pytest.fixture(params=[True, False])
def using_nan_is_na(request):
    with pd.option_context("future.distinguish_nan_and_na", not request.param):
        yield request.param


@pytest.fixture
def data_missing():
    return index(["", "foo bar baz"])


@pytest.fixture
def na_cmp():
    return lambda x, y: x == Terms({}) or y == Terms({})


@pytest.fixture
def na_value():
    return Terms({})


@pytest.fixture
def data_repeated(data):
    def gen(count):
        for _ in range(count):
            yield data

    return gen


@pytest.fixture
def invalid_scalar(data):
    return 123


@pytest.fixture
def data_for_sorting():
    return index(["abba mmma dabbb", "abba abba aska", "caa cata"])


@pytest.fixture
def data_missing_for_sorting():
    return index(["abba mmma dabbb", "", "caa cata"])


@pytest.fixture
def data_for_grouping():
    return index(
        ["abba mmma dabbb", "abba mmma dabbb", "", "", "caa cata", "caa cata",
         "abba mmma dabbb", "abba abba aska"]
    )


@pytest.fixture(
    params=[
        lambda x: 1,
        lambda x: [1] * len(x),
        lambda x: pd.Series([1] * len(x)),
        lambda x: x,
    ],
    ids=["scalar", "list", "series", "object"],
)
def groupby_apply_op(request):
    return request.param


@pytest.fixture(params=["data", "data_missing"])
def all_data(request, data, data_missing):
    if request.param == "data":
        return data
    return data_missing


@pytest.fixture(params=[None, lambda x: x])
def sort_by_key(request):
    return request.param


@pytest.fixture(params=[True, False])
def box_in_series(request):
    return request.param


@pytest.fixture(params=[True, False])
def as_series(request):
    return request.param


@pytest.fixture(params=[True, False])
def as_frame(request):
    return request.param


@pytest.fixture(params=[True, False])
def use_numpy(request):
    return request.param


@pytest.fixture(params=[True, False])
def as_array(request):
    return request.param


@pytest.fixture(params=["ffill", "bfill"])
def fillna_method(request):
    return request.param


class TestDType(base.BaseDtypeTests):
    pass


class TestInterface(base.BaseInterfaceTests):
    pass


class TestConstructors(base.BaseConstructorsTests):
    pass


class TestReshaping(base.BaseReshapingTests):
    pass


class TestGetItem(base.BaseGetitemTests):
    pass


class TestCasting(base.BaseCastingTests):
    pass


class TestPrinting(base.BasePrintingTests):
    pass


class TestMissing(base.BaseMissingTests):
    pass


class TestMethods(base.BaseMethodsTests):
    # Unique not supported on inverted index rows, for performance
    # reasons: the two suites tests/test_extension_array.py leaves out,
    # as the reference's own test/test_extension_array.py:151-159 does
    def test_value_counts_with_normalize(self, data):
        pass

    def test_unique(self, data):
        pass


class TestSetItem(base.BaseSetitemTests):
    @pytest.mark.xfail(
        reason="pandas cannot .loc-index by an arbitrary object scalar: "
        "Index._check_indexing_error requires lib.is_scalar(key), which is "
        "False for Terms (pandas' own JSONArray test EA only dodges this "
        "because its UserDict scalar is unhashable, skipping the test)"
    )
    def test_loc_setitem_with_expansion_preserves_ea_index_dtype(self, data):
        super().test_loc_setitem_with_expansion_preserves_ea_index_dtype(data)


class TestGroupby(base.BaseGroupbyTests):
    pass
