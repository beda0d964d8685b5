"""Boston housing, regression (counterpart of
``transmogrifai_tpu.examples.boston``, the same definitions): thirteen
housing numbers through ``transmogrify`` into ``RegressionModelSelector``
with a train/validation split.

    from transmogrifai_tpu_torch.examples.boston import build_workflow
    wf, label, prediction = build_workflow("housing.data")
    model = wf.train()                 # on the CUDA device

The file is whitespace-separated without a header (the reference's
``housing.data``, not in this repository: pass a file of that schema).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..features import Feature, FeatureBuilder
from ..impl.feature.transmogrifier import transmogrify
from ..impl.selector.factories import RegressionModelSelector
from ..readers.readers import CSVReader
from ..workflow import OpWorkflow

BOSTON_SCHEMA = ["crim", "zn", "indus", "chas", "nox", "rm", "age", "dis",
                 "rad", "tax", "ptratio", "b", "lstat", "medv"]
DEFAULT_PATH = ("/root/reference/helloworld/src/main/resources/"
                "BostonDataset/housing.data")


def boston_features() -> Tuple[Feature, Feature]:
    """(medv label, feature vector)."""
    label = FeatureBuilder.RealNN("medv").extract_field().as_response()
    preds = []
    for c in BOSTON_SCHEMA[:-1]:
        if c == "chas":
            preds.append(FeatureBuilder.Binary(c).extract(
                lambda r: bool(r.get("chas"))).as_predictor())
        else:
            preds.append(FeatureBuilder.Real(c).extract_field()
                         .as_predictor())
    return label, transmogrify(preds)


def build_workflow(path: str = DEFAULT_PATH, seed: int = 42, models=None,
                   device: Optional[str] = None):
    """(workflow, label, prediction) over the housing file at ``path``;
    ``models`` pins the selector's list (None: the default list)."""
    label, vec = boston_features()
    pred = (RegressionModelSelector
            .with_train_validation_split(seed=seed, models=models)
            .set_input(label, vec).get_output())
    reader = CSVReader(path, schema=BOSTON_SCHEMA, header=False,
                       whitespace=True)
    wf = (OpWorkflow(device=device).set_reader(reader)
          .set_result_features(pred))
    return wf, label, pred


def main(path: str = DEFAULT_PATH):
    wf, label, pred = build_workflow(path)
    model = wf.train()
    print(model.summary_pretty())
    return model


if __name__ == "__main__":
    main()
