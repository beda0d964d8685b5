"""Iris, multiclass (counterpart of ``transmogrifai_tpu.examples.iris``,
the same definitions): four measurements through ``transmogrify`` into
``MultiClassificationModelSelector`` with 3-fold cross-validation.

    from transmogrifai_tpu_torch.examples.iris import build_workflow
    wf, label, prediction = build_workflow("iris.data")
    model = wf.train()                 # on the CUDA device

The default path is the reference's iris file; it is not in this
repository, so pass a file of the same schema (headerless CSV), e.g. the
seeded synthetic one ``write_iris_file`` writes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..features import Feature, FeatureBuilder
from ..impl.feature.transmogrifier import transmogrify
from ..impl.selector.factories import MultiClassificationModelSelector
from ..readers.readers import Frame, read_csv
from ..workflow import OpWorkflow

IRIS_SCHEMA = ["sepalLength", "sepalWidth", "petalLength", "petalWidth",
               "irisClass"]
DEFAULT_PATH = ("/root/reference/helloworld/src/main/resources/"
                "IrisDataset/iris.data")
_CLASSES = ("Iris-setosa", "Iris-versicolor", "Iris-virginica")


def dropna(frame: Frame) -> Frame:
    """The frame without its rows that miss a value (``DataFrame.dropna``)."""
    keep = np.ones(frame.num_rows, dtype=bool)
    for col in frame.columns.values():
        if col.dtype.kind == "f":
            keep &= ~np.isnan(col)
        elif col.dtype == object:
            keep &= np.array([not (v is None or (isinstance(v, float)
                                                 and v != v)) for v in col],
                             dtype=bool)
    return Frame({n: c[keep] for n, c in frame.columns.items()})


def write_iris_file(path: str, n: int = 150, seed: int = 0) -> str:
    """A seeded synthetic iris file in the reference's schema (headerless
    CSV, one decimal, the classes in turn, a blank last line); -> path."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for i in range(n):
            c = i % 3
            vals = rng.randn(4) * 0.4 + np.array([5.0, 3.4, 1.5, 0.2]) \
                + c * np.array([0.9, -0.6, 2.5, 1.0])
            fh.write(",".join(f"{v:.1f}" for v in vals) + f",{_CLASSES[c]}\n")
        fh.write("\n")
    return path


def iris_features() -> Tuple[Feature, Feature]:
    """(label, feature vector): the label is the class's index."""
    label = FeatureBuilder.RealNN("irisClass").extract(
        lambda r: float(_CLASSES.index(r.get("irisClass")))
        if r.get("irisClass") in _CLASSES else None).as_response()
    nums = [FeatureBuilder.RealNN(c).extract_field().as_predictor()
            for c in IRIS_SCHEMA[:4]]
    return label, transmogrify(nums)


def build_workflow(path: str = DEFAULT_PATH, seed: int = 42, models=None,
                   device: Optional[str] = None):
    """(workflow, label, prediction) over the iris file at ``path``;
    ``models`` pins the selector's list (None: the default list)."""
    frame = dropna(read_csv(path, schema=IRIS_SCHEMA, header=False))
    label, vec = iris_features()
    pred = (MultiClassificationModelSelector
            .with_cross_validation(seed=seed, models=models)
            .set_input(label, vec).get_output())
    wf = (OpWorkflow(device=device).set_input_dataset(frame)
          .set_result_features(pred))
    return wf, label, pred


def main(path: str = DEFAULT_PATH):
    wf, label, pred = build_workflow(path)
    model = wf.train()
    print(model.summary_pretty())
    return model


if __name__ == "__main__":
    main()
