"""The port's ``MacauConfig`` YAML files (``utils/config.py``:
``from_yaml`` / ``to_yaml``): a round trip in the port, and files written
by either package read by the other.  A JAX file's TPU-only ``pallas`` key
is dropped when it holds "auto" and refused otherwise."""
import dataclasses

import pytest
import yaml

from bayesiandatafusion_jl_tpu.utils.config import MacauConfig as JaxConfig
from bayesiandatafusion_jl_tpu_torch.utils.config import MacauConfig

OPTS = dict(num_latent=16, burnin=7, clamp=(1.0, 5.0), gram_dtype="bfloat16",
            bucket_widths=(8, 64), dense_int8=True, head_split_degree=7,
            dtype="float64", metrics_every=5)


def fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("pallas", None)
    return d


def test_yaml_round_trip(tmp_path):
    p = str(tmp_path / "cfg.yaml")
    for cfg in (MacauConfig(), MacauConfig(**OPTS)):
        cfg.to_yaml(p)
        back = MacauConfig.from_yaml(p)
        assert back == cfg
        assert isinstance(back.bucket_widths, tuple)


def test_yaml_written_by_jax_reads_in_the_port(tmp_path):
    p = str(tmp_path / "jax.yaml")
    want = JaxConfig(**OPTS)
    want.to_yaml(p)
    got = MacauConfig.from_yaml(p)
    assert fields(got) == fields(want)
    # the JAX file's budget (its default, a TPU's) stays as written
    assert got.dense_gram_budget_gb == 9.0 != MacauConfig().dense_gram_budget_gb
    assert isinstance(got.clamp, tuple)


@pytest.mark.parametrize("pallas", ["on", "off", True])
def test_yaml_with_a_pallas_setting_is_refused(tmp_path, pallas):
    p = tmp_path / "jax.yaml"
    JaxConfig(**OPTS).to_yaml(str(p))
    data = yaml.safe_load(p.read_text())
    data["pallas"] = pallas
    p.write_text(yaml.safe_dump(data, sort_keys=False))
    with pytest.raises(ValueError, match="pallas"):
        MacauConfig.from_yaml(str(p))


def test_yaml_written_by_the_port_reads_in_jax(tmp_path):
    p = str(tmp_path / "port.yaml")
    cfg = MacauConfig(**OPTS)
    cfg.to_yaml(p)
    got = JaxConfig.from_yaml(p)
    assert got.pallas == "auto"
    assert fields(got) == fields(cfg)
    assert got == JaxConfig(**OPTS, dense_gram_budget_gb=16.0)
