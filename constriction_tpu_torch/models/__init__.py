"""Exactly-invertible fixed-point entropy models (a rebuild of
constriction's model layer; see the reference's src/stream/model.rs).

``fast_quantized_cdf`` is also the categorical CDF builder of the port's
interleaved coders (``ops/framing.py``, ``parallel/dryrun.py``).

JAX counterpart: ``constriction_tpu/models/__init__.py``, with the same
exports.
"""

from .base import EntropyModel, ImpossibleSymbol, ModelFamily
from .categorical import (
    ContiguousCategoricalEntropyModel,
    ContiguousLookupDecoderModel,
    LazyContiguousCategoricalEntropyModel,
    NonContiguousCategoricalDecoderModel,
    NonContiguousCategoricalEncoderModel,
    NonContiguousLookupDecoderModel,
    fast_quantized_cdf,
    perfectly_quantized_probabilities,
)
from .quantized import (
    Binomial,
    BinomialFamily,
    CallbackDistribution,
    CallbackFamily,
    Cauchy,
    Gaussian,
    Laplace,
    LeakilyQuantizedDistribution,
    LeakyQuantizer,
    QuantizedFamily,
)
from .uniform import UniformModel

__all__ = [
    "EntropyModel",
    "ImpossibleSymbol",
    "ModelFamily",
    "ContiguousCategoricalEntropyModel",
    "ContiguousLookupDecoderModel",
    "LazyContiguousCategoricalEntropyModel",
    "NonContiguousCategoricalDecoderModel",
    "NonContiguousCategoricalEncoderModel",
    "NonContiguousLookupDecoderModel",
    "fast_quantized_cdf",
    "perfectly_quantized_probabilities",
    "Binomial",
    "BinomialFamily",
    "CallbackDistribution",
    "CallbackFamily",
    "Cauchy",
    "Gaussian",
    "Laplace",
    "LeakilyQuantizedDistribution",
    "LeakyQuantizer",
    "QuantizedFamily",
    "UniformModel",
]
