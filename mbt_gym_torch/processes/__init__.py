from mbt_gym_torch.processes.arrivals import HawkesArrivals, PoissonArrivals, PoissonArrivalsNonLinear
from mbt_gym_torch.processes.base import ProcessBase
from mbt_gym_torch.processes.fills import ExogenousMmFill, ExponentialFill, PowerFill, TriangularFill
from mbt_gym_torch.processes.impact import (
    TemporaryAndPermanentImpact,
    TemporaryAndTransientImpact,
    TemporaryPowerImpact,
    TransientImpact,
)
from mbt_gym_torch.processes.midprice import (
    BrownianMotionJumpMidprice,
    BrownianMotionMidprice,
    CevMidprice,
    ConstantMidprice,
    GeometricBrownianMotionMidprice,
    HestonMidprice,
    OuJumpMidprice,
    OuMidprice,
    ShortTermJumpAlphaMidprice,
    ShortTermOuAlphaMidprice,
)
