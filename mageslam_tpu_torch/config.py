"""Settings of the port: a copy of the JAX package's `mageslam_tpu/config.py`.

The settings dataclasses mirror the reference's PROPERTYBAG settings
(Core/MAGESLAM/Source/MageSettings.h) 1:1 in names and defaults, plus the
`Budgets` of fixed array capacities; `golden_path_settings` is the Console
golden-path configuration. The port keeps its own copy so that it never
imports or reads the JAX package; tests/test_torch_config.py holds the two
copies equal field by field.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from dataclasses import dataclass, field
from typing import Any


class CameraIdentity(enum.IntEnum):
    # MageSettings.h:13-18
    MONO = 0
    STEREO_1 = 1
    STEREO_2 = 2


class FilterType(enum.IntEnum):
    # MageSettings.h:20-26
    NONE = 0
    FUSER3DOF = 1
    FUSER6DOF = 2
    SIMPLE6DOF = 3


class PosePriorMethod(enum.IntEnum):
    # MageSettings.h:28-33
    MOTION_MODEL = 0
    VISUAL_INERTIAL_FUSION = 1
    VISUAL_INERTIAL_FUSION_WITH_3DOF = 2


@dataclass(frozen=True)
class OrbMatcherSettings:
    # MageSettings.h:36-39
    MaxHammingDistance: int = 30
    MinHammingDifference: int = 1


@dataclass(frozen=True)
class BundleAdjustSettings:
    # MageSettings.h:41-52
    NumSteps: int = 1
    NumStepsPerRun: int = 1
    MinSteps: int = 1
    HuberWidth: float = 1.8
    HuberWidthScale: float = 0.95
    MaxOutlierError: float = 7.25
    MaxOutlierErrorScaleFactor: float = 0.95
    MinMeanSquareError: float = 0.25
    DistanceTetherWeight: float = 50.0
    LowConnectivityIterationsScale: float = 1.5


@dataclass(frozen=True)
class NewMapPointsCreationSettings:
    # MageSettings.h:54-65
    MinParallaxDegrees: float = 0.0238961594253207
    MaxEpipolarError: float = 3.84385518580709
    MinAcceptedDistanceRatio: float = 2.0
    MinKeyframeDistanceForCreatingMapPointsSquared: float = 0.0
    MaxKeyframeAngleDegrees: float = 60.0
    NewMapPointsSearchRadius: float = 11.8816156
    MaxFramesForNewPointsCreation: int = 5
    InitialMatcherSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)
    AssociateMatcherSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)


@dataclass(frozen=True)
class GraphOptimizationSettings:
    # MageSettings.h:67-73
    MaxOutlierError: float = 7.25
    MaxOutlierErrorScaleFactor: float = 0.95
    NumSteps: int = 0
    BundleAdjustmentHuberWidth: float = 0.372231848644798


@dataclass(frozen=True)
class CovisibilitySettings:
    # MageSettings.h:75-83
    CovisMinThreshold: int = 15
    CovisLoopThreshold: int = 30
    CovisEssentialThreshold: int = 100
    UpperConnectionsForBA: int = 2000
    LowerConnectionsForBA: int = 1500
    CovisBaStepThreshold: int = 15
    MaxSteps: int = 1


@dataclass(frozen=True)
class KeyframeSettings:
    # MageSettings.h:85-94
    KeyframeDecisionMinFrameCount: int = 60
    KeyframeDecisionMinFrameCountReloc: int = 20
    KeyframeDecisionMinTrackingPointCount: int = 25
    KeyframeDecisionMaxTrackingPointOverlap: float = 0.25
    KeyframeDecisionMaxTrackingPointMatches: float = 300
    MappingMaxTrackingPointOverlap: float = 0.9
    MinimumKeyframeCovisibilityCount: int = 3
    MinFrameMoveToMinDepthRatio: float = 0.13


@dataclass(frozen=True)
class MonoMapInitializationSettings:
    # MageSettings.h:96-133
    FundamentalTransferErrorThreshold: float = 1.1
    MinFeatureMatches: int = 65
    MinScoringInliers: int = 50
    MinInlierPercentage: float = 0.5
    MinInitialMapPoints: int = 40
    MinMapPoints: int = 60
    MinThirdFrameMatchPercentage: float = 0.5
    FeatureCovisibilityThreshold: float = 0.35
    MaxParallax3dDistance: float = 500.0
    MaxParallax3dMedianDistance: float = 20.0
    MinCandidatePoseDisimilarity: float = 0.3
    MaxPoseContributionZ: float = 0.66
    BundleAdjustmentG2OSteps: int = 5
    BundleAdjustmentHuberWidth: float = 1.5
    RansacIterationsForModels: int = 90
    MaxEpipolarError: float = 3.5
    MaxOutlierError: float = 2.5
    AmountBACanChangePose: float = 1.65
    MapInitializationNewPointsCreationMinDistance: float = 0.25
    MapInitFrameIntervalMilliseconds: int = 0
    MinInitializationIntervalMilliseconds: int = 150
    MaxInitializationIntervalMilliseconds: int = 540
    MinPixelSpread: float = 40.0
    FinalBA_HuberWidth: float = 0.9
    FinalBA_MaxOutlierError: float = 4.0
    FinalBA_MaxOutlierErrorScaleFactor: float = 0.75
    FinalBA_MinMeanSquareError: float = 0.0
    FinalBA_NumStepsPerRun: int = 5
    FinalBA_NumSteps: int = 15
    ExtraFrame_MaxOutlierError: float = 8.0
    ExtraFrame_BundleAdjustmentSteps: int = 5
    ExtraFrame_HuberWidth: float = 4.0
    ExtraFrame_SearchRadius: float = 40.0
    FivePointMatchingSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)
    ExtraFrameMatchingSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)
    NewMapPointsCreationSettings: NewMapPointsCreationSettings = field(
        default_factory=NewMapPointsCreationSettings
    )


@dataclass(frozen=True)
class StereoMapInitializationSettings:
    # MageSettings.h:135-147
    MinInitMapPoints: int = 15
    MinFeatureMatches: int = 40
    MaxOutlierError: float = 2.5
    MaxEpipolarError: float = 5.5
    MinAcceptedDistanceRatio: float = 2.0
    InitializationTetherStrength: float = 50.0
    MaxPoseContributionZ: float = 0.10
    AmountBACanChangePose: float = 1.65
    MaxDepthMeters: float = 2.3
    OrbMatcherSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)
    BundleAdjustSettings: BundleAdjustSettings = field(default_factory=BundleAdjustSettings)


@dataclass(frozen=True)
class FeatureExtractorSettings:
    # MageSettings.h:151-167
    NumFeatures: int = 440
    ScaleFactor: float = 1.5
    GaussianKernelSize: int = 7
    NumLevels: int = 1
    FastThreshold: int = 4
    PatchSize: int = 15
    UseOrientation: bool = False
    FeatureFactor: float = 1.5
    FeatureStrength: float = 0.9
    StrongResponse: int = 20
    MinRobustnessFactor: float = 1.1
    MaxRobustnessFactor: float = 2.0
    NumCellsX: int = 32
    NumCellsY: int = 32
    # EXTENSION (not in MageSettings.h): spatially-uniform feature selection.
    # The reference's RetainBestFeatures (OpenCVModified.cpp:571-613) cuts the
    # candidate pool by a GLOBAL response histogram before ANMS; when one image
    # region is much higher-contrast than the rest (e.g. a close low-texture
    # surface filling most of the view), that region's candidates monopolise
    # the budget and tracking starves elsewhere. When true, selection instead
    # ranks candidates by (response-rank within grid cell, response) — a
    # round-robin over cells that guarantees every textured cell a share of
    # the budget while degrading gracefully to response order when cells are
    # empty. False (default) reproduces the reference pipeline exactly.
    # Applies to TRACKING frames only: while the session is uninitialized the
    # frontend always uses the reference selection — 5-point init needs the
    # strongest, most repeatable corners, and round-robin selection drops
    # mutual match counts below MinFeatureMatches on small baselines
    # (measured on the photoreal sweep: 45-60 vs 61-78 two-way matches).
    SpatialFeatureSelection: bool = False
    SpatialSelectionGridX: int = 8
    SpatialSelectionGridY: int = 6

    @property
    def ImageBorder(self) -> float:
        # MageSettings.h:166
        return self.PatchSize / 2.0


@dataclass(frozen=True)
class PoseEstimationSettings:
    # MageSettings.h:170-178
    SearchRadius: float = 12.0
    WiderSearchRadius: float = 24.0
    ExtraWiderSearchRadius: float = 36.0
    FeatureMatchThreshold: int = 20
    FeatureSmallMatchRatioThreshold: float = 0.333780871615353
    MinMapPointRefinementCount: int = 0
    OrbMatcherSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)


@dataclass(frozen=True)
class TrackLocalMapSettings:
    # MageSettings.h:180-195
    MinDegreesBetweenCurrentViewAndMapPointView: float = 60.0
    BundleAdjustmentG2OSteps: int = 4
    BundleAdjustmentHuberWidth: float = 0.9
    InitialPoseEstimateBundleAdjustmentSteps: int = 3
    InitialPoseEstimateBundleAdjustmentHuberWidth: float = 4.0
    RecentMapPointPctSuccess: float = 0.137686914508039
    MatchSearchRadius: float = 8.0
    MaxOutlierError: float = 4.5
    MaxOutlierErrorPoseEstimation: float = 6.0
    UnassociateOutliers: bool = True
    TrackingLostCountUntilReloc: int = 3
    MinMapPointRefinementCount: int = 0
    MinTrackedFeatureCount: int = 20
    OrbMatcherSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)


@dataclass(frozen=True)
class LoopClosureSettings:
    # MageSettings.h:197-207
    EnableLoopClosure: bool = False
    MaxMapPoints: int = 200
    MatchSearchRadius: float = 18.0
    MinKeyframe: int = 10
    MinClusterSize: int = 3
    MinFeatureMatches: int = 0
    BundleAdjustSettings: BundleAdjustSettings = field(default_factory=BundleAdjustSettings)
    CheapLoopClosureMatchingSettings: OrbMatcherSettings = field(
        default_factory=OrbMatcherSettings
    )
    MapMergeMatchingSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)
    # EXTENSION (not in MageSettings.h): Sim(3) essential-graph iterations run
    # after the closed-form loop correction to distribute accumulated drift
    # over the whole trajectory (BundlerLib declares the PoseGraphOptimizer
    # but Core never wires it; 0 = reference behavior, closed form + global
    # BA only). See runtime/loop_closure.essential_graph_refine.
    EssentialGraphIterations: int = 12


@dataclass(frozen=True)
class PoseHistorySettings:
    # MageSettings.h:209-214
    InitalInterpolationConnections: int = 4
    MaxInterpolationConnections: int = 1
    PoseHistoryInitialSize: int = 10000
    KeyframeHistoryInitialSize: int = 1000


@dataclass(frozen=True)
class BoundingDepthSettings:
    # MageSettings.h:216-223
    RegionOfInterestMinX: float = 0.1
    RegionOfInterestMinY: float = 0.1
    RegionOfInterestMaxX: float = 0.9
    RegionOfInterestMaxY: float = 0.9
    NearDepthSoftness: float = 0.0
    FarDepthSoftness: float = 0.0


@dataclass(frozen=True)
class BagOfWordsSettings:
    # MageSettings.h:225-234
    QualifyingCandidateScore: float = 0.75
    UseDirectIndex: bool = True
    DirectIndexLevels: int = 4
    TrainingFrames: int = 15
    TrainingTreeLevels: int = 2
    TrainingTreeBranchingFactor: int = 6
    MaxTrainingIteration: int = 12
    MinTrainingSize: int = 1000


@dataclass(frozen=True)
class RelocalizationSettings:
    # MageSettings.h:236-250
    MinBruteForceCorrespondences: int = 20
    MinRadiusMatchCorrespondences: int = 15
    MinMapPoints: int = 10
    RansacInliersPctRequired: float = 0.4
    BundleAdjustInliersPctRequired: float = 0.4
    RansacConfidence: float = 0.6
    RoundRobinIterations: int = 5
    RansacIterations: int = 2
    BundleAdjustIterations: int = 10
    SearchRadius: float = 20.0
    MaxBundleAdjustReprojectionError: float = 8.0
    MaxBundlePnPReprojectionError: float = 8.0
    OrbMatcherSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)


@dataclass(frozen=True)
class MappingSettings:
    # MageSettings.h:253-262
    MaxRelocQueryResults: int = 4
    MaxPendingKeyframes: int = 4
    MaxLoopClosureQueryResults: int = 1000
    MinNumKeyframesForMapPointCulling: int = 3
    UseCheapLoopClosure: bool = True
    PersistLambda: bool = True
    MinLambda: float = 0.001
    NewMapPointsCreationSettings: NewMapPointsCreationSettings = field(
        default_factory=NewMapPointsCreationSettings
    )


@dataclass(frozen=True)
class PosePriorSettings:
    # MageSettings.h:264-267
    PosePrior: PosePriorMethod = PosePriorMethod.MOTION_MODEL
    AssumeIMUAndCameraAreAtSamePosition: bool = False


@dataclass(frozen=True)
class RuntimeSettings:
    # MageSettings.h:269-273
    TrackingReadsPerLoopDetection: int = 2
    TrackingReadsPerLoopClosure: int = 30
    PosePriorSettings: PosePriorSettings = field(default_factory=PosePriorSettings)


@dataclass(frozen=True)
class FuserSettings:
    # MageSettings.h:276-287
    UseFuser: bool = True
    ReturnFuserOutput: bool = False
    ApplyVisualUpdate: bool = True
    StdDevPoseError: float = 0.004
    DropMagSamples: bool = True
    DeltaPoseRateMS: int = 66
    MinDeltaPoseRateMS: int = 65
    MaxDeltaPoseRateMS: int = 129
    FilterType: FilterType = FilterType.FUSER3DOF
    OrbMatcherSettings: OrbMatcherSettings = field(default_factory=OrbMatcherSettings)


@dataclass(frozen=True)
class VolumeOfInterestSettings:
    # MageSettings.h:290-307
    Threshold: float = 0.5
    Iterations: int = 3
    VoxelCountFloor: int = 16000
    AwayProminence: float = 1.2
    TowardProminence: float = 0.1
    SideProminence: float = 1.0
    KernelAngleXRads: float = math.radians(60.0)
    KernelAngleYRads: float = math.radians(40.0)
    KernelPitchRads: float = 0.0
    KernelRollRads: float = 0.0
    KernelYawRads: float = math.radians(5.0)
    KernelDepthModifier: float = 1.0


@dataclass(frozen=True)
class PerCameraSettings:
    # MageSettings.h:309-319
    FeatureExtractorSettings: FeatureExtractorSettings = field(
        default_factory=FeatureExtractorSettings
    )
    NewPointGridWidth: int = 4
    NewPointGridHeight: int = 3
    NewPointMaxGridCount: int = 6
    UndistortImagePixels: bool = False
    KeyframeDecisionGridWidth: int = 8
    KeyframeDecisionGridHeight: int = 5
    KeyframeDecisionMinMapPointsPerGridCell: int = 2
    KeyframeDecisionAllowedEmptyCellPercentage: float = 0.4


@dataclass(frozen=True)
class StereoSettings:
    # MageSettings.h:321-327
    UseStereoInit: bool = False
    PrimaryTrackingCamera: CameraIdentity = CameraIdentity.STEREO_2
    Camera1: PerCameraSettings = field(default_factory=PerCameraSettings)
    Camera2: PerCameraSettings = field(default_factory=PerCameraSettings)
    StereoMapInitializationSettings: StereoMapInitializationSettings = field(
        default_factory=StereoMapInitializationSettings
    )


@dataclass(frozen=True)
class MonoSettings:
    # MageSettings.h:329-332
    MonoCamera: PerCameraSettings = field(default_factory=PerCameraSettings)
    MonoMapInitializationSettings: MonoMapInitializationSettings = field(
        default_factory=MonoMapInitializationSettings
    )


@dataclass(frozen=True)
class Metadata:
    # MageSettings.h:334-337
    LoadedFromFile: bool = False
    TrackingWidth: int = 320


@dataclass(frozen=True)
class Budgets:
    """Static padded-array capacities for the TPU rebuild (not in the reference —
    the C++ grows vectors dynamically; XLA requires static shapes). Derived from
    SURVEY.md §5.7: NumFeatures=440 → 512 padded; local BA targets 1500-2000
    observations; pending keyframes cap 4; loop-closure point sample cap 200."""

    MaxFeatures: int = 512          # padded keypoint/descriptor slots per frame
    MaxKeyframes: int = 256         # map keyframe capacity
    MaxMapPoints: int = 8192        # map point capacity
    MaxBaCameras: int = 32          # local BA camera window capacity
    MaxBaPoints: int = 2048         # local BA point capacity
    MaxBaObservations: int = 4096   # local BA observation capacity (>2000 target)
    MaxGlobalBaObservations: int = 16384  # global BA observation capacity
    TrackingHistoryLength: int = 5  # historical_queue<HistoricalFrame, 5>
    BaPointChunk: int = 512         # lax.scan chunk for Schur accumulation
    MaxInitFrames: int = 4          # mono-init frame accumulator capacity
    RansacBatch: int = 128          # batched RANSAC hypothesis count (>= 90 reference iters)
    MaxTethers: int = 16            # persistent keyframe tether bank (Data/Tether.h)


@dataclass(frozen=True)
class MageSlamSettings:
    # MageSettings.h:340-359
    Metadata: Metadata = field(default_factory=Metadata)
    BundleAdjustSettings: BundleAdjustSettings = field(default_factory=BundleAdjustSettings)
    GraphOptimizationSettings: GraphOptimizationSettings = field(
        default_factory=GraphOptimizationSettings
    )
    CovisibilitySettings: CovisibilitySettings = field(default_factory=CovisibilitySettings)
    KeyframeSettings: KeyframeSettings = field(default_factory=KeyframeSettings)
    PoseEstimationSettings: PoseEstimationSettings = field(
        default_factory=PoseEstimationSettings
    )
    RelocalizationSettings: RelocalizationSettings = field(
        default_factory=RelocalizationSettings
    )
    BagOfWordsSettings: BagOfWordsSettings = field(default_factory=BagOfWordsSettings)
    TrackLocalMapSettings: TrackLocalMapSettings = field(default_factory=TrackLocalMapSettings)
    PoseHistorySettings: PoseHistorySettings = field(default_factory=PoseHistorySettings)
    BoundingDepthSettings: BoundingDepthSettings = field(default_factory=BoundingDepthSettings)
    MappingSettings: MappingSettings = field(default_factory=MappingSettings)
    RuntimeSettings: RuntimeSettings = field(default_factory=RuntimeSettings)
    FuserSettings: FuserSettings = field(default_factory=FuserSettings)
    LoopClosureSettings: LoopClosureSettings = field(default_factory=LoopClosureSettings)
    VolumeOfInterestSettings: VolumeOfInterestSettings = field(
        default_factory=VolumeOfInterestSettings
    )
    StereoSettings: StereoSettings = field(default_factory=StereoSettings)
    MonoSettings: MonoSettings = field(default_factory=MonoSettings)
    Budgets: Budgets = field(default_factory=Budgets)


def get_settings_for_camera(settings: MageSlamSettings,
                            camera: CameraIdentity) -> PerCameraSettings:
    """The per-camera settings of `camera` (MageSettings.h:365-379)."""
    if camera == CameraIdentity.MONO:
        return settings.MonoSettings.MonoCamera
    if camera == CameraIdentity.STEREO_1:
        return settings.StereoSettings.Camera1
    if camera == CameraIdentity.STEREO_2:
        return settings.StereoSettings.Camera2
    raise ValueError(f"Unhandled CameraIdentity {camera}")


def _from_dict(cls: type, data: dict[str, Any]) -> Any:
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[f.name] = _from_dict(f.type, value)
        elif isinstance(value, dict):
            # resolve string annotation
            ftype = f.type if isinstance(f.type, type) else globals().get(str(f.type))
            kwargs[f.name] = _from_dict(ftype, value) if ftype else value
        else:
            kwargs[f.name] = value
    return cls(**kwargs)


def load_settings(path_or_dict: str | dict[str, Any]) -> MageSlamSettings:
    """Load settings from a JSON file or dict; unknown keys ignored, missing keys
    defaulted (mirrors the cereal/propertybag JSON loading of the reference,
    Apps/Console/console.cpp:91-289)."""
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            data = json.load(f)
    else:
        data = path_or_dict
    s = _from_dict(MageSlamSettings, data)
    return dataclasses.replace(s, Metadata=dataclasses.replace(s.Metadata, LoadedFromFile=True))


def to_dict(settings: Any) -> dict[str, Any]:
    """The settings as nested dicts, the form `load_settings` reads."""
    return dataclasses.asdict(settings)


def golden_path_settings() -> MageSlamSettings:
    """The COMPLETE Console golden-path configuration — every override the
    reference console applies on top of MageSettings.h defaults
    (Apps/Console/console.cpp:91-289), not just the headline ones. These are
    MAGE's actually-tuned operating point (tight TLM radius/outlier gates,
    MinKeyframeDistanceForCreatingMapPointsSquared=0.25 as the absolute
    triangulation-baseline floor that blocks monocular scale collapse,
    MinMapPointRefinementCount=1, CovisMinThreshold=10, ...).

    One deliberate deviation: EnableLoopClosure=True. The reference console
    leaves the MageSettings.h default (false, MageSettings.h:198) even though
    it tunes the loop-closure BA parameters; we enable it so the golden path
    exercises the full capability."""
    return load_settings({
        "FuserSettings": {"UseFuser": False},
        "Metadata": {"TrackingWidth": 320},
        "BundleAdjustSettings": {"MaxOutlierError": 3.0, "HuberWidth": 0.9},
        "GraphOptimizationSettings": {"MaxOutlierError": 3.5},
        "LoopClosureSettings": {
            "EnableLoopClosure": True,
            "BundleAdjustSettings": {
                "MinSteps": 25, "NumSteps": 25, "NumStepsPerRun": 25,
                "HuberWidth": 0.372231, "MaxOutlierError": 7.25,
            },
            "CheapLoopClosureMatchingSettings": {
                "MaxHammingDistance": 35, "MinHammingDifference": 1},
            "MapMergeMatchingSettings": {
                "MaxHammingDistance": 20, "MinHammingDifference": 1},
        },
        "KeyframeSettings": {"KeyframeDecisionMaxTrackingPointOverlap": 0.5},
        "PoseEstimationSettings": {
            "MinMapPointRefinementCount": 1,
            "OrbMatcherSettings": {
                "MaxHammingDistance": 30, "MinHammingDifference": 1},
        },
        "RelocalizationSettings": {
            "OrbMatcherSettings": {
                "MaxHammingDistance": 40, "MinHammingDifference": 1},
        },
        "CovisibilitySettings": {"CovisMinThreshold": 10},
        "TrackLocalMapSettings": {
            "MaxOutlierError": 2.25,
            "MaxOutlierErrorPoseEstimation": 4.0,
            "MatchSearchRadius": 4.0,
            "InitialPoseEstimateBundleAdjustmentHuberWidth": 3.25,
            "MinMapPointRefinementCount": 1,
            "RecentMapPointPctSuccess": 0.25,
            "OrbMatcherSettings": {
                "MaxHammingDistance": 35, "MinHammingDifference": 1},
        },
        "PoseHistorySettings": {
            "InitalInterpolationConnections": 4,
            "MaxInterpolationConnections": 6,
        },
        "MappingSettings": {
            "NewMapPointsCreationSettings": {
                "MaxEpipolarError": 5.5,
                "NewMapPointsSearchRadius": 11.0,
                "MinParallaxDegrees": 0.25,
                "MinKeyframeDistanceForCreatingMapPointsSquared": 0.25,
                "InitialMatcherSettings": {
                    "MaxHammingDistance": 25, "MinHammingDifference": 1},
                "AssociateMatcherSettings": {
                    "MaxHammingDistance": 35, "MinHammingDifference": 1},
            },
        },
        "RuntimeSettings": {"TrackingReadsPerLoopClosure": 0},
        "MonoSettings": {
            "MonoCamera": {
                "KeyframeDecisionAllowedEmptyCellPercentage": 0.6,
                "FeatureExtractorSettings": {
                    "NumFeatures": 440, "ScaleFactor": 1.5, "NumLevels": 1,
                    "FastThreshold": 4, "PatchSize": 15, "FeatureFactor": 1.5,
                    "StrongResponse": 20, "MinRobustnessFactor": 1.1,
                    "MaxRobustnessFactor": 2.2,
                },
            },
            "MonoMapInitializationSettings": {
                "MinInlierPercentage": 0.65,
                "MinInitialMapPoints": 40,
                "FeatureCovisibilityThreshold": 0.35,
                "MaxInitializationIntervalMilliseconds": 330,
                "FinalBA_HuberWidth": 0.75,
                "FivePointMatchingSettings": {
                    "MaxHammingDistance": 30, "MinHammingDifference": 1},
                "ExtraFrameMatchingSettings": {
                    "MaxHammingDistance": 30, "MinHammingDifference": 1},
                "NewMapPointsCreationSettings": {
                    "MaxEpipolarError": 2.0,
                    "NewMapPointsSearchRadius": 7.0,
                    "InitialMatcherSettings": {
                        "MaxHammingDistance": 30, "MinHammingDifference": 1},
                    "AssociateMatcherSettings": {
                        "MaxHammingDistance": 35, "MinHammingDifference": 1},
                },
            },
        },
    })
