"""Blender camera math in numpy (counterpart of ``fenet/geometry/camera.py``;
the reference's utils/cam_read.py without its import-time side effects).

Host metadata math, the port's own copy of fenet's numpy functions: the
per-view table :data:`PARAMS` (cam_read.py:11-48: azimuth, elevation,
in-plane angle, distance ratio, focal and sensor mm, the camera's maximum
distance and the object's x/y/z shift of each rendered view of the R2N2
demo model), Blender's K and RT, the 4x4 rotation helpers, the az/el/inl
camera stack, and :func:`reproject_views`, the reference's
``gen_obj_img_h5()`` demo as a function.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

ROT90Y = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)

# Per-view camera metadata (cam_read.py:11-48): one row per rendering view,
# columns [azimuth_deg, elevation_deg, in-plane_deg, distance_ratio,
#          focal_mm, sensor_mm, cam_max_dist, shift_x, shift_y, shift_z].
PARAMS = np.array([
    [13.609081057113638, 44.08659091162214, 0, 0.7250000039172821, 35, 32, 1.75, 0.011900090612471104, 0.18190337717533112, 0.006238838657736778],
    [18.771401768548415, 18.1609811873455, 0, 0.8679759320460956, 35, 32, 1.75, 0.09003015607595444, -0.14270350337028503, 0.05223459377884865],
    [25.878850162901006, 41.81812383397336, 0, 0.9751217424184879, 35, 32, 1.75, 0.18383225798606873, -0.009411958046257496, 0.09324256330728531],
    [35.99688020783701, 44.16026916688504, 0, 0.7531933092574246, 35, 32, 1.75, 0.19104833900928497, 0.04526694118976593, 0.18508180975914001],
    [48.19587966587669, 5.634790095730125, 0, 0.8690428772309136, 35, 32, 1.75, -0.1652826964855194, 0.08896388858556747, 0.16622555255889893],
    [63.86510514171296, 38.54127457742132, 0, 0.7137306097298087, 35, 32, 1.75, -0.040847986936569214, 0.10500576347112656, 0.06099827215075493],
    [71.03331485170746, 31.445728064763074, 0, 0.7631809542510639, 35, 32, 1.75, 0.05915249139070511, -0.19200047850608826, 0.1869116872549057],
    [78.93149731392128, 8.373853466957998, 0, 0.9278049610816022, 35, 32, 1.75, 0.04910890385508537, 0.18967053294181824, 0.09642542898654938],
    [92.93504577985884, 30.47282082362938, 0, 0.9460081651709269, 35, 32, 1.75, 0.11576724052429199, -0.19369271397590637, -0.10284043103456497],
    [104.06258690756752, 34.89268826144493, 0, 0.9681601773368812, 35, 32, 1.75, 0.04314812645316124, -0.15145060420036316, -0.1740894317626953],
    [108.95573152324525, 23.11176700395444, 0, 0.770639013064592, 35, 32, 1.75, 0.15823353826999664, 0.13090209662914276, -0.05024176836013794],
    [116.6008502422741, 0.2166350071844464, 0, 0.9161140203446375, 35, 32, 1.75, 0.04646913707256317, -0.1679994910955429, 0.14490677416324615],
    [130.58465088703826, 5.184621942865357, 0, 0.8602119283710821, 35, 32, 1.75, -0.0523235946893692, 0.08109834790229797, 0.041353490203619],
    [140.0814191209536, 30.7580598376864, 0, 0.8225658059383021, 35, 32, 1.75, 0.02494741417467594, -0.15723608434200287, 0.1662987470626831],
    [151.6945424628218, 40.30938294045265, 0, 0.8300863497152311, 35, 32, 1.75, 0.04902523383498192, 0.12987209856510162, -0.14116427302360535],
    [155.10293763254376, 36.00196909180084, 0, 0.9385488975504941, 35, 32, 1.75, -0.060411594808101654, 0.11220726370811462, 0.14445669949054718],
    [172.66686856029312, 23.401623371118287, 0, 0.6077178503384195, 35, 32, 1.75, 0.18273067474365234, 0.024926139041781425, 0.07727616280317307],
    [184.39893514490126, 26.50639191519731, 0, 0.7616966307025058, 35, 32, 1.75, 0.11640718579292297, -0.15759973227977753, 0.08047189563512802],
    [186.31522987643604, 22.34199368701631, 0, 0.781413880723633, 35, 32, 1.75, 0.09689559042453766, -0.18857409060001373, 0.10417064279317856],
    [200.3669351695706, 30.966916192283943, 0, 0.9726330816884996, 35, 32, 1.75, -0.10276813805103302, -0.03201678767800331, 0.1582796275615692],
    [212.81609745138903, 5.242959119303972, 0, 0.9610687351783843, 35, 32, 1.75, -0.03486974909901619, -0.07885606586933136, 0.06740577518939972],
    [222.69074555755464, 34.97655081294485, 0, 0.7449820536270011, 35, 32, 1.75, 0.15827082097530365, -0.15252475440502167, -0.02471393346786499],
    [226.36156985649166, 24.12025052159019, 0, 0.6084750359327343, 35, 32, 1.75, 0.16977459192276, -0.1849607676267624, 0.16296547651290894],
    [238.13127042168853, 38.96101470087499, 0, 0.9527401793315309, 35, 32, 1.75, 0.03490840271115303, -0.14361941814422607, 0.0456993505358696],
    [246.6971544140491, 42.96785554909819, 0, 0.7632392246742773, 35, 32, 1.75, 0.07354340702295303, -0.19146820902824402, 0.029128391295671463],
    [263.188201153171, 43.58194878329786, 0, 0.9971558337468894, 35, 32, 1.75, -0.07030873000621796, 0.015776721760630608, -0.15853647887706757],
    [273.5738581640022, 21.771445368627766, 0, 0.9574869361642284, 35, 32, 1.75, 0.1489466279745102, -0.0993940532207489, 0.06929264217615128],
    [277.83357477482525, 44.22157811849666, 0, 0.7603451527181114, 35, 32, 1.75, 0.11418163776397705, -0.14371995627880096, -0.09554994851350784],
    [286.95374625476126, 14.978816297828445, 0, 0.8355745390330079, 35, 32, 1.75, 0.029406240209937096, -0.09835749864578247, 0.1129160076379776],
    [301.2761431690078, 2.2205958119809477, 0, 0.9640588118493543, 35, 32, 1.75, -0.039721615612506866, -0.1531001478433609, -0.06817512214183807],
    [305.53574837592873, 30.577959276347084, 0, 0.9563756397852338, 35, 32, 1.75, -0.1973000019788742, -0.07772478461265564, -0.09494104981422424],
    [324.94101052194753, 25.490943074788202, 0, 0.8470615554015754, 35, 32, 1.75, -0.009690315462648869, -0.18609729409217834, -0.028144175186753273],
    [331.9528475015708, 27.953736988053663, 0, 0.9882868522848163, 35, 32, 1.75, -0.03387337923049927, 0.004485097248107195, -0.05609232187271118],
    [335.20370027377317, 27.595871390765616, 0, 0.6746722947065639, 35, 32, 1.75, -0.09185966849327087, -0.02847306989133358, 0.09793012589216232],
    [348.3053274377389, 5.936488500371313, 0, 0.9645940583148378, 35, 32, 1.75, -0.09842805564403534, 0.009305895306169987, 0.194208025932312],
    [357.5995457541137, 22.899753896755964, 0, 0.7912261645286426, 35, 32, 1.75, -0.00983845442533493, 0.18935218453407288, -0.007812697440385818],
], np.float64)

# Blender constants (cam_read.py:53-60).
F_MM = 35.0
SENSOR_SIZE_MM = 32.0
CAM_MAX_DIST = 1.75
CAM_ROT = np.array(
    [
        [1.910685676922942e-15, 4.371138828673793e-08, 1.0],
        [1.0, -4.371138828673793e-08, -0.0],
        [4.371138828673793e-08, 1.0, -4.371138828673793e-08],
    ]
)


def get_blender_proj(
    az: float, el: float, distance_ratio: float,
    img_w: int = 224, img_h: int = 224,
) -> Tuple[np.ndarray, np.ndarray]:
    """K (3x3) and RT (3x4) from azimuth/elevation/distance (cam_read.py:51-100)."""
    f_u = F_MM * img_w / SENSOR_SIZE_MM
    f_v = F_MM * img_h / SENSOR_SIZE_MM
    k = np.array([[f_u, 0.0, img_w / 2.0],
                  [0.0, f_v, img_h / 2.0],
                  [0.0, 0.0, 1.0]])

    sa, ca = np.sin(np.radians(-az)), np.cos(np.radians(-az))
    se, ce = np.sin(np.radians(-el)), np.cos(np.radians(-el))
    r_world2obj = np.array(
        [[ca * ce, -sa, ca * se], [sa * ce, ca, sa * se], [-se, 0, ce]]
    ).T
    r_obj2cam = CAM_ROT.T
    r_world2cam = r_obj2cam @ r_world2obj
    cam_location = np.array([distance_ratio * CAM_MAX_DIST, 0, 0])
    t_world2cam = -1 * r_obj2cam @ cam_location
    r_camfix = np.diag([1.0, -1.0, -1.0])
    r_world2cam = r_camfix @ r_world2cam
    t_world2cam = r_camfix @ t_world2cam
    return k, np.hstack([r_world2cam, t_world2cam[:, None]])


# --- 4x4 rotation/scale helpers (cam_read.py:103-142) -----------------------


def rotation_matrix_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
        np.float64,
    )


def rotation_matrix_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array(
        [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
        np.float64,
    )


def rotation_matrix_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float64,
    )


_SCALE_Y_NEG = np.diag([1.0, -1.0, 1.0, 1.0])
_NEG = np.diag([-1.0, -1.0, -1.0, 1.0])


def get_rotate_matrix(angle: float) -> np.ndarray:
    """The reference's composite obj->world rotation
    (cam_read.py:103-142): neg @ Rz @ Rz @ scale_y_neg @ Rx."""
    rz = rotation_matrix_z(angle)
    return np.linalg.multi_dot(
        [_NEG, rz, rz, _SCALE_Y_NEG, rotation_matrix_x(angle)]
    )


def get_w2o_mat(shift: Sequence[float]) -> np.ndarray:
    """World->object 4x4 translation (cam_read.py:166-174)."""
    t = np.eye(4)
    t[:3, 3] = np.asarray(shift, np.float64)
    return t


def get_norm_matrix(sdf_h5_file: str) -> np.ndarray:
    """T_inv @ M_inv from an SDF sample h5's norm_params
    (cam_read.py:145-163). Requires h5py."""
    import h5py

    with h5py.File(sdf_h5_file, "r") as h5_f:
        norm_params = h5_f["norm_params"][:]
    center, m = norm_params[:3], norm_params[3]
    m_inv = np.diag([m, m, m, 1.0])
    t_inv = np.eye(4)
    t_inv[:3, 3] = center
    return t_inv @ m_inv


# --- az/el/inl camera stack (cam_read.py:251-311) ----------------------------


def degree2rad(param: np.ndarray) -> np.ndarray:
    """Radians with the reference's +180-degree azimuth shift
    (cam_read.py:305-310); only the first three entries change."""
    out = np.array(param, np.float64)
    out[0] = np.deg2rad(param[0] + 180.0)
    out[1] = np.deg2rad(param[1])
    out[2] = np.deg2rad(param[2])
    return out


def _rot_az(az: float) -> np.ndarray:
    c, s = np.cos(az), np.sin(az)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rot_el(el: float) -> np.ndarray:
    c, s = np.cos(el), np.sin(el)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_inl(inl: float) -> np.ndarray:
    c, s = np.cos(inl), np.sin(inl)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def camera_info(param: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(cam_mat, cam_pos) from a radians param row (cam_read.py:256-262,
    :266-271): cam_mat = (inl @ el @ az).T, cam_pos = -(0, 0, dist)."""
    cam_mat = (_rot_inl(param[2]) @ _rot_el(param[1]) @ _rot_az(param[0])).T
    cam_pos = -1 * np.array([0.0, 0.0, param[3]])
    return cam_mat, cam_pos


def get_img_cam(param: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """camera_info over a degrees PARAMS row (cam_read.py:251-254)."""
    return camera_info(degree2rad(np.asarray(param, np.float64)))


# --- reprojection ------------------------------------------------------------


def project_points(points: np.ndarray, trans_mat_right: np.ndarray) -> np.ndarray:
    """Homogeneous-project (N, 3) world points with a (4, 3) right-multiply
    transform to integer pixel xy (cam_read.py:248-259 get_img_points)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    homo = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=-1)
    xyz = (homo @ trans_mat_right).reshape(-1, 3)
    return (xyz[:, :2] / xyz[:, 2:3]).astype(np.int32)


def view_transform(param: Sequence[float], img_w: int = 128,
                   img_h: int = 128,
                   norm_mat: Optional[np.ndarray] = None) -> np.ndarray:
    """The full per-view obj->pixel transform gen_obj_img_h5 assembles
    (cam_read.py:216-235): K @ RT @ rotate(-pi/2) @ W2O [@ norm], returned
    transposed for right-multiplication of homogeneous points."""
    az, el, distance_ratio = param[0], param[1], param[3]
    k, rt = get_blender_proj(az, el, distance_ratio, img_w=img_w, img_h=img_h)
    rot_mat = get_rotate_matrix(-np.pi / 2)
    w2o = get_w2o_mat((param[-3], param[-1], -param[-2]))
    mats = [k, rt, rot_mat, w2o]
    if norm_mat is not None:
        mats.append(norm_mat)
    return np.linalg.multi_dot(mats).T


def reproject_views(
    img_dir: str,
    out_dir: Optional[str] = None,
    points: Optional[np.ndarray] = None,
    params: Optional[np.ndarray] = None,
    img_hw: Tuple[int, int] = (128, 128),
    radius: int = 10,
) -> list:
    """Pure-function equivalent of the reference's import-time
    ``gen_obj_img_h5()`` demo (cam_read.py:197-245): for each view param
    row, reproject ``points`` (default: the origin) into the rendering
    ``NN.png`` and write an annotated ``NN_out.png``.

    Returns the per-view list of projected pixel arrays.
    """
    import os

    import cv2

    if points is None:
        points = np.zeros((1, 3))
    if params is None:
        params = PARAMS
    out_dir = out_dir or img_dir
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for i, param in enumerate(params):
        img_file = os.path.join(img_dir, f"{i:02d}.png")
        if not os.path.exists(img_file):
            break
        trans = view_transform(param, img_w=img_hw[1], img_h=img_hw[0])
        pc_xy = project_points(points, trans)
        img_arr = cv2.imread(img_file, cv2.IMREAD_UNCHANGED)
        for x, y in pc_xy:
            cv2.circle(img_arr, (int(x), int(y)), radius, (0, 0, 255, 255), -2)
        cv2.imwrite(os.path.join(out_dir, f"{i:02d}_out.png"), img_arr)
        results.append(pc_xy)
    return results


def get_img_points(pcl: np.ndarray, k: np.ndarray, rt: np.ndarray,
                   img_hw: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Reproject a world-space cloud to integer pixel coordinates
    (K @ RT pinhole projection, clipped to the image)."""
    homo = np.concatenate([pcl, np.ones((len(pcl), 1))], axis=1)
    cam = (rt @ homo.T)
    uvw = k @ cam
    uv = (uvw[:2] / uvw[2:]).T
    return np.clip(np.round(uv).astype(np.int64),
                   0, max(img_hw) - 1)


def transform_points(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Apply (B, 3, 4) RT or (B, 3, 3) K to (B, N, 3) points (common.py:21-40)."""
    if transform.shape[2] == 4:
        r, t = transform[:, :, :3], transform[:, :, 3:]
        return points @ r.transpose(0, 2, 1) + t.transpose(0, 2, 1)
    return points @ transform.transpose(0, 2, 1)


def normalize_imagenet(x: np.ndarray) -> np.ndarray:
    """ImageNet normalization for (B, H, W, 3) 0..1 images (common.py:8-18)."""
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (x - mean) / std
